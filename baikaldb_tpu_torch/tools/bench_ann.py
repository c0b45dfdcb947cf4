"""ANN harness: IVF candidates + exact re-rank against brute force, on any
device (the port of ``baikaldb_tpu/tools/bench_ann.py``).

    python -m baikaldb_tpu_torch.tools.bench_ann [--rows 1000000] [--dim 128]
        [--queries 32] [--k 10] [--nprobe 8] [--device cpu]

The data is ``bench/ann.py``'s generator.  k-means and the exact per-query
top-k run on ``--device`` (the CUDA card unless it names another); the IVF
search runs on the host over the packed layout, as the SQL path's candidate
generation does.  Times are host wall clock with the card synchronized
around each call (``python -m baikaldb_tpu_torch.bench.ann`` times the
card with CUDA events).  Prints ONE JSON line.  A package tool, not the
port's benchmark: it reads no BENCHMARK.json.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--nprobe", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None,
                    help="torch device of k-means and the exact top-k "
                         "(default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from ..bench.ann import make_data
    from ..ops.vector import brute_force_topk, ivf_search_host, kmeans, pack_ivf
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)

    def timed(fn, reps: int = 3):
        out = fn()                          # warm caches and kernels
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) / reps, out

    base, queries, nc = make_data(args.rows, args.dim, args.queries, args.seed)
    t0 = time.perf_counter()
    cent, assign = kmeans(base, nc, iters=6, device=dev)
    train_s = time.perf_counter() - t0
    order, starts, counts, _ = pack_ivf(base, assign, n_clusters=len(cent))
    base_sorted = base[order]
    norms = (base_sorted * base_sorted).sum(1)
    qd = torch.from_numpy(queries).to(dev)
    bd = torch.from_numpy(base).to(dev)

    # per-query timing on both sides: the SQL plane serves one SELECT at a
    # time, so batch-amortized exact numbers would overstate brute force
    exact_s, exact_out = timed(lambda: [
        brute_force_topk(qd[i:i + 1], bd, None, args.k, "l2", "f32")
        for i in range(args.queries)])
    ivf_s, ivf_out = timed(lambda: [
        ivf_search_host(queries[i], base_sorted, None, cent, starts, counts,
                        args.k, args.nprobe, "l2", norms_sorted=norms)
        for i in range(args.queries)])
    ei = np.stack([i[0].cpu().numpy() for _s, i in exact_out])
    vi = [order[p] for _s, p in ivf_out]
    recall = float(np.mean([len(set(ei[i]) & set(vi[i])) / min(args.k, len(vi[i]))
                            for i in range(args.queries)]))
    print(json.dumps({
        "metric": f"ANN IVF speedup ({args.rows}x{args.dim}, k={args.k}, "
                  f"nprobe={args.nprobe})",
        "value": exact_s / ivf_s, "unit": "x vs exact",
        "recall_at_k": recall, "exact_ms": exact_s * 1e3, "ivf_ms": ivf_s * 1e3,
        "train_s": train_s, "device": str(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
