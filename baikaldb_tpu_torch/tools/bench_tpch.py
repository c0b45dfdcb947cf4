"""TPC-H wall-clock harness: all 22 queries end to end through the port's
Session (the port of ``baikaldb_tpu/tools/bench_tpch.py``).

    python -m baikaldb_tpu_torch.tools.bench_tpch [--scale 0.05] [--mesh N]
        [--repeat 3] [--json] [--queries q1,q6] [--force-shuffle]
        [--no-multiway] [--device cpu]

Prints per-query first-run and best warm times (host wall clock, the card
synchronized around each run) and a JSON summary line; with ``--json``
every query emits one machine-readable line instead of the human row:
wall-clock (first + best warm), shuffle rounds per execution and plans
built (plan-cache misses).  The engine runs on the CUDA card unless
``--device`` names another.  A package tool, not the port's benchmark: it
reads no BENCHMARK.json.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--mesh", type=int, default=0,
                    help="run distributed over an N-shard mesh")
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--json", action="store_true",
                    help="one machine-readable JSON line per query")
    ap.add_argument("--force-shuffle", action="store_true",
                    help="repartition every sharded join input")
    ap.add_argument("--no-multiway", action="store_true",
                    help="disable the keyed exchange scheduler")
    ap.add_argument("--queries", default="",
                    help="comma-separated subset (e.g. q5,q7); empty = all 22")
    ap.add_argument("--device", default=None,
                    help="torch device of the engine (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from ..exec.session import Session
    from ..models import tpch
    from ..utils import metrics
    from ..utils.device import resolve_device
    from ..utils.flags import set_flag

    if args.force_shuffle:
        set_flag("mpp_force_shuffle", True)
        set_flag("dense_join_span_max", 0)
    if args.no_multiway:
        set_flag("multiway_join", False)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    mesh = None
    if args.mesh:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(args.mesh, device=dev)
    s = Session(device=dev, mesh=mesh)
    t0 = time.perf_counter()
    tpch.load_into(s, scale=args.scale, seed=42)
    load_s = time.perf_counter() - t0
    n_li = s.db.stores["default.lineitem"].num_rows
    header = {"scale": args.scale, "lineitem": n_li, "device": str(dev),
              "mesh": args.mesh or 1, "force_shuffle": bool(args.force_shuffle),
              "multiway": not args.no_multiway, "load_s": round(load_s, 3)}
    print(json.dumps({"header": header}) if args.json else
          f"# scale={args.scale} lineitem={n_li} device={dev} "
          f"mesh={args.mesh or 1} load={load_s:.1f}s", flush=True)

    only = {q.strip() for q in args.queries.split(",") if q.strip()}
    results = {}
    total_warm = 0.0
    for name in sorted(tpch.QUERIES, key=lambda q: int(q[1:])):
        if only and name not in only:
            continue
        sql = tpch.QUERIES[name]
        p0 = metrics.plan_cache_misses.value
        sync()
        t0 = time.perf_counter()
        s.query(sql)
        sync()
        first = time.perf_counter() - t0
        first_plans = metrics.plan_cache_misses.value - p0
        warm, rounds, plans = [], 0, 0
        for _ in range(args.repeat):
            r0 = metrics.shuffle_rounds.value
            p0 = metrics.plan_cache_misses.value
            sync()
            t0 = time.perf_counter()
            s.query(sql)
            sync()
            warm.append(time.perf_counter() - t0)
            rounds = metrics.shuffle_rounds.value - r0
            plans += metrics.plan_cache_misses.value - p0
        w = min(warm) if warm else first
        total_warm += w
        results[name] = round(w * 1e3, 3)
        if args.json:
            print(json.dumps({"query": name, "first_ms": round(first * 1e3, 3),
                              "warm_ms": round(w * 1e3, 3), "shuffle_rounds": rounds,
                              "first_plans": first_plans, "warm_plans": plans}),
                  flush=True)
        else:
            print(f"{name:>4}: first {first * 1e3:8.1f} ms   warm {w * 1e3:8.1f} ms",
                  flush=True)
    print(json.dumps({"metric": f"tpch warm total (SF{args.scale}, {dev}, "
                                f"mesh={args.mesh or 1})",
                      "value": round(total_warm * 1e3, 3), "unit": "ms",
                      "per_query_ms": results,
                      "multiway_joins_fused": metrics.multiway_joins_fused.value,
                      "shuffle_rounds_saved": metrics.shuffle_rounds_saved.value}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
