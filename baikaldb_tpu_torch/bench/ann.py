"""ANN benchmark on the card: IVF candidates + exact re-rank against brute
force, the port of ``baikaldb_tpu/tools/bench_ann.py``.

The data is that script's: ``RandomState(seed)`` (42 by default), ``nc =
max(64, sqrt(n))`` centres drawn ×4, each row a centre plus noise ×0.4, the
queries base rows plus noise ×0.1.  k-means (6 iterations) and the exact
per-query top-k (float32) run on the card; the IVF search runs on the host
over the packed layout, as the SQL path's candidate generation does.
Device times come from CUDA events, host times from the host clock.
Prints ONE JSON line; needs a CUDA device.

    python -m baikaldb_tpu_torch.bench.ann [--rows 1000000] [--dim 128]
        [--queries 32] [--k 10] [--nprobe 8] [--seed 42]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


def make_data(rows: int, dim: int, queries: int, seed: int = 42):
    """-> (base [rows, dim] float32, queries [queries, dim] float32, nc):
    the clustered generator of ``tools/bench_ann.py``."""
    rng = np.random.RandomState(seed)
    nc = max(64, int(np.sqrt(rows)))
    centers = rng.randn(nc, dim).astype(np.float32) * 4
    base = (centers[rng.randint(0, nc, rows)]
            + rng.randn(rows, dim).astype(np.float32) * 0.4)
    qs = (base[rng.randint(0, rows, queries)]
          + rng.randn(queries, dim).astype(np.float32) * 0.1)
    return base, qs, nc


def event_ms(fn, reps: int = 3) -> tuple[float, object]:
    """Median CUDA-event milliseconds of ``fn()`` over ``reps`` calls after
    one warm-up call, and the last call's result."""
    out = fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--nprobe", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench.ann: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1

    from ..ops.vector import brute_force_topk, ivf_search_host, kmeans, pack_ivf

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    base, queries, nc = make_data(args.rows, args.dim, args.queries, args.seed)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cent, assign = kmeans(base, nc, iters=6, device=dev)
    train_s = time.perf_counter() - t0
    order, starts, counts, _ = pack_ivf(base, assign, n_clusters=len(cent))
    base_sorted = base[order]
    norms = (base_sorted * base_sorted).sum(1)

    qd = torch.from_numpy(queries).to(dev)
    bd = torch.from_numpy(base).to(dev)

    # per-QUERY timing on both sides, as in the JAX script: the SQL plane
    # serves one SELECT at a time, so batch-amortized exact numbers would
    # overstate brute force
    def run_exact():
        return [brute_force_topk(qd[i:i + 1], bd, None, args.k, "l2", "f32")
                for i in range(args.queries)]

    def run_batch():
        return brute_force_topk(qd, bd, None, args.k, "l2", "f32")

    def run_ivf():
        return [ivf_search_host(queries[i], base_sorted, None, cent, starts, counts,
                                args.k, args.nprobe, "l2", norms_sorted=norms)
                for i in range(args.queries)]

    exact_ms, exact_out = event_ms(run_exact)
    batch_ms, _ = event_ms(run_batch)
    run_ivf()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        ivf_out = run_ivf()
        walls.append((time.perf_counter() - t0) * 1e3)
    ivf_ms = statistics.median(walls)
    ei = np.stack([i[0].cpu().numpy() for _s, i in exact_out])
    vi = [order[p] for _s, p in ivf_out]
    recall = float(np.mean([len(set(ei[i]) & set(vi[i])) / min(args.k, len(vi[i]))
                            for i in range(args.queries)]))
    print(json.dumps({
        "metric": f"ANN IVF speedup ({args.rows}x{args.dim}, k={args.k}, "
                  f"nprobe={args.nprobe})",
        "value": exact_ms / ivf_ms, "unit": "x vs exact",
        "recall_at_k": recall,
        "exact_ms": exact_ms / args.queries, "exact_batch_ms": batch_ms,
        "ivf_host_ms": ivf_ms / args.queries, "train_s": train_s,
        "platform": "gpu", "device": torch.cuda.get_device_name(0), "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
