"""Vector search: exact top-k, IVF-Flat and k-means (BASELINE config #4).

The port of ``baikaldb_tpu/ops/vector.py``.  A brute-force scan is a matrix
product, ``[q, d] x [d, n]``, then a top-k; IVF-Flat keeps the rows of the
``nprobe`` nearest centroids' clusters (as in the JAX package, the full
product masked to the probed clusters); k-means trains the centroids.
Deleted rows are a validity mask, like the reference's faiss delete bitmap.

Where the port differs from the JAX package, and why:

- bf16 scores: the JAX package multiplies bf16-rounded inputs and returns
  float32 (``preferred_element_type``).  ``torch.matmul`` of two bf16
  tensors returns bf16, which would round every score, so here the inputs
  are rounded to bf16 and multiplied as float32: the same products (one of
  two bf16 values is exact in float32), accumulated and returned in float32.
  Float32 products run at torch's default precision, which takes no TF32
  shortcut, as the reference's f32 is full float32; nothing here changes
  that process-wide setting.
- Top-k ties: ``jax.lax.top_k`` puts the lower index first among equal
  scores and ``torch.topk`` promises no order, so ``_topk`` takes one top-k
  over an int64 key: the score's order-preserving int32 image above the
  inverted index.
- ``ivf_topk``'s probe mask is a ``[q, nc]`` mask gathered by ``assign``,
  not the ``[q, n, nprobe]`` broadcast (8 GB at q = 1024, n = 1M).
- k-means' centroids turn float64 after the first step (float32 sums over
  float64 counts, the JAX package's x64 promotion); they are scored against
  the rows in float32, where the JAX package's mixed float32 x float64
  product rounds to float32 at another ulp.

``kmeans`` and ``VectorIndex`` run on CUDA unless given ``device="cpu"``
(``None`` raises without CUDA); ``brute_force_topk`` and ``ivf_topk`` run
where their tensors lie.  ``pack_ivf``, ``_np_scores`` and
``ivf_search_host`` are the JAX package's numpy host code, copied.  On the
card, k-means' per-cluster counts (``seg_sum`` of 1-D float64 ones over at
most ``onehot_max_segments`` clusters) take the segment kernel; the
``[n, d]`` centroid sums stay on the scatter, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .segments import seg_sum

_LOW32 = 0xFFFFFFFF


def _scores(queries: torch.Tensor, base: torch.Tensor, metric: str,
            precision: str) -> torch.Tensor:
    """[q, d] x [n, d] -> [q, n] float32 scores, higher is nearer (L2: the
    negated squared distance)."""
    q, b = queries.float(), base.float()
    if precision == "bf16":
        q = q.to(torch.bfloat16).float()
        b = b.to(torch.bfloat16).float()
    dots = q @ b.T
    if metric == "ip":
        return dots
    if metric == "cosine":
        qn = torch.linalg.vector_norm(queries, dim=1, keepdim=True).float()
        bn = torch.linalg.vector_norm(base, dim=1, keepdim=True).float()
        return dots / torch.clamp(qn * bn.T, min=1e-30)
    if metric == "l2":
        # ||q-b||^2 = ||q||^2 - 2qb + ||b||^2; score = -distance, in place
        # (k-means' [n, nc] is 4 GB at 1M x 1000) and in the reference's
        # order: -((q2 - 2 dots) + b2)
        q2 = torch.sum(queries.float() ** 2, dim=1, keepdim=True)
        b2 = torch.sum(base.float() ** 2, dim=1)
        return dots.mul_(-2.0).add_(q2).add_(b2[None, :]).neg_()
    raise ValueError(f"unknown metric {metric}")


def _ordered_i32(s: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 that orders as the floats do (-inf lowest)."""
    bits = s.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _topk(s: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` of each row of float32 ``s`` -> (scores, int64 indices),
    highest first and the lower index first among equal scores (the order
    of ``jax.lax.top_k``)."""
    n = s.shape[1]
    inv = _LOW32 - torch.arange(n, dtype=torch.int64, device=s.device)
    key = _ordered_i32(s).to(torch.int64).mul_(1 << 32).add_(inv)
    top = torch.topk(key, k, dim=1).values
    idx = _LOW32 - (top & _LOW32)
    return torch.gather(s, 1, idx), idx


def brute_force_topk(queries, base, valid, k: int, metric: str = "l2",
                     precision: str = "bf16"):
    """Exact top-k: [q, d] queries against [n, d] base -> (scores, indices).

    ``valid`` is the live-row mask (deletes / MVCC visibility — the analog of
    the reference's faiss delete bitmap merged at search time)."""
    s = _scores(queries, base, metric, precision)
    if valid is not None:
        s.masked_fill_(~valid[None, :], float("-inf"))
    return _topk(s, k)


def ivf_topk(queries, base, valid, centroids, assign, k: int, nprobe: int,
             metric: str = "l2", precision: str = "bf16"):
    """IVF-Flat: keep the rows of the ``nprobe`` nearest centroids'
    clusters only.

    assign: [n] centroid id per base vector.  Scores of rows outside the
    probed clusters are masked: a row is in when its cluster's slot of the
    [q, nc] probe mask is set."""
    cs = _scores(queries, centroids, metric, precision)
    _, probe = _topk(cs, nprobe)                        # [q, nprobe]
    s = _scores(queries, base, metric, precision)       # [q, n]
    probe_mask = torch.zeros(cs.shape, dtype=torch.bool, device=cs.device)
    probe_mask.scatter_(1, probe, True)
    in_probe = probe_mask.index_select(1, assign.to(torch.int64))
    if valid is not None:
        in_probe &= valid[None, :]
    s.masked_fill_(~in_probe, float("-inf"))
    return _topk(s, k)


def pack_ivf(vectors: np.ndarray, assign: np.ndarray,
             n_clusters: int | None = None):
    """Cluster-sorted layout for the gather-based IVF path: rows of one
    cluster are contiguous, so probing nprobe clusters gathers nprobe
    ranges instead of scoring the whole base (the faiss inverted-list
    layout).  -> (order, starts, counts, max_count); base rows must be
    reindexed by ``order``.

    ``n_clusters`` MUST be the centroid count when clusters can be empty
    (k-means keeps old centroids for empty clusters): the search scores
    every centroid, so starts/counts must cover them all."""
    order = np.argsort(assign, kind="stable")
    sa = assign[order]
    nc = n_clusters if n_clusters is not None else \
        (int(assign.max()) + 1 if len(assign) else 1)
    counts = np.bincount(sa, minlength=nc)
    starts = np.zeros(nc, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    return (order.astype(np.int64), starts,
            counts.astype(np.int64), int(counts.max() if len(counts) else 1))


def _np_scores(q: np.ndarray, rows: np.ndarray, metric: str,
               norms=None) -> np.ndarray:
    dots = rows @ q
    if metric == "ip":
        return dots
    if metric == "cosine":
        qn = np.linalg.norm(q)
        rn = np.sqrt(norms) if norms is not None \
            else np.linalg.norm(rows, axis=1)
        return dots / np.maximum(rn * qn, 1e-30)
    if norms is None:
        norms = (rows * rows).sum(1)
    return -(norms - 2.0 * dots + float(q @ q))                  # l2


def ivf_search_host(qvec: np.ndarray, matrix_sorted: np.ndarray,
                    valid_sorted, centroids: np.ndarray,
                    starts: np.ndarray, counts: np.ndarray,
                    k: int, nprobe: int, metric: str = "l2",
                    norms_sorted=None):
    """Host-side IVF over the packed layout: gather EXACTLY the probed
    clusters' rows and score them with BLAS.  This is the SQL path's
    candidate generation: the work scales with the probed fraction, and
    the candidates' exact re-rank then runs on the device.  -> (scores,
    positions-into-sorted-order)."""
    q = np.asarray(qvec, np.float32)
    cs = _np_scores(q, centroids, metric)
    nprobe = min(nprobe, len(centroids))
    probe = np.argpartition(cs, -nprobe)[-nprobe:]
    idx = np.concatenate([np.arange(starts[p], starts[p] + counts[p])
                          for p in probe]) if len(probe) else \
        np.zeros(0, np.int64)
    if len(idx) == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.int64)
    s = _np_scores(q, matrix_sorted[idx], metric,
                   norms_sorted[idx] if norms_sorted is not None else None)
    if valid_sorted is not None:
        s = np.where(valid_sorted[idx], s, -np.inf)
    kk = min(k, len(idx))
    top = np.argpartition(s, -kk)[-kk:]
    top = top[np.argsort(-s[top])]
    return s[top], idx[top]


def _kmeans_step(x: torch.Tensor, c: torch.Tensor, nc: int, ones: torch.Tensor):
    d = _scores(x, c, "l2", "f32")                # [n, nc] (neg dist)
    a = torch.argmax(d, dim=1)
    del d
    sums = seg_sum(x, a, nc)                      # [nc, d] float32
    cnt = seg_sum(ones, a, nc)                    # [nc] float64
    newc = sums / torch.clamp(cnt[:, None], min=1.0)
    # keep old centroid for empty clusters
    newc = torch.where(cnt[:, None] > 0, newc, c.to(newc.dtype))
    return newc, a


def kmeans(vectors: np.ndarray, n_clusters: int, iters: int = 10,
           seed: int = 0, device=None):
    """Lloyd's k-means on ``device`` (IVF training — the faiss train
    analog); the initial centroids are the JAX package's, drawn by
    ``np.random.default_rng(seed).choice``.

    Returns (centroids [c, d] float64, assign [n] int64) as numpy."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(vectors), size=n_clusters, replace=False)
    centroids = torch.as_tensor(np.asarray(vectors[idx], np.float32), device=dev)
    x = torch.as_tensor(np.asarray(vectors, np.float32), device=dev)
    ones = torch.ones(x.shape[0], dtype=torch.float64, device=dev)
    assign = None
    for _ in range(iters):
        centroids, assign = _kmeans_step(x, centroids, n_clusters, ones)
    return (centroids.cpu().numpy(),
            None if assign is None else assign.cpu().numpy())


class VectorIndex:
    """Per-table vector index: exact by default, IVF above a size threshold.

    API mirrors the reference's VectorIndex surface (insert/delete/search with
    payload ids + visibility) minus the RocksDB persistence, which the storage
    tier provides.  The device copy (base, mask, centroids) lives on
    ``device``: CUDA unless ``"cpu"`` is named."""

    def __init__(self, dim: int, metric: str = "l2", ivf_threshold: int = 65536,
                 n_clusters: int | None = None, nprobe: int = 8, device=None):
        self.device = resolve_device(device)
        self.dim = dim
        self.metric = metric
        self.ivf_threshold = ivf_threshold
        self.n_clusters = n_clusters
        self.nprobe = nprobe
        self._vecs = np.zeros((0, dim), np.float32)
        self._ids = np.zeros((0,), np.int64)
        self._live = np.zeros((0,), bool)
        self._device = None           # (base, valid, centroids, assign) | None

    def __len__(self):
        return int(self._live.sum())

    def add(self, ids: np.ndarray, vectors: np.ndarray):
        vectors = np.asarray(vectors, np.float32).reshape(-1, self.dim)
        ids = np.asarray(ids, np.int64)
        self._vecs = np.concatenate([self._vecs, vectors])
        self._ids = np.concatenate([self._ids, ids])
        self._live = np.concatenate([self._live, np.ones(len(ids), bool)])
        self._device = None

    def delete(self, ids) -> int:
        mask = np.isin(self._ids, np.asarray(list(ids), np.int64)) & self._live
        self._live[mask] = False
        if self._device is not None:
            # deletes only flip visibility: refresh the mask, keep the base
            # matrix and IVF centroids/assignments (no retrain)
            base, _, cent, assign = self._device
            self._device = (base, torch.as_tensor(self._live, device=self.device),
                            cent, assign)
        return int(mask.sum())

    def _prepare(self):
        if self._device is not None:
            return self._device
        base = torch.as_tensor(self._vecs, device=self.device)
        valid = torch.as_tensor(self._live, device=self.device)
        cent = assign = None
        if len(self._vecs) >= self.ivf_threshold:
            nc = self.n_clusters or max(16, int(np.sqrt(len(self._vecs))))
            c, a = kmeans(self._vecs, nc, device=self.device)
            cent = torch.as_tensor(c, device=self.device)
            assign = torch.as_tensor(a, device=self.device)
        self._device = (base, valid, cent, assign)
        return self._device

    def search(self, queries: np.ndarray, k: int):
        """-> (ids [q, k], scores [q, k]); dead slots get id -1."""
        if len(self._vecs) == 0:
            q = np.atleast_2d(queries).shape[0]
            return np.full((q, k), -1, np.int64), np.full((q, k), -np.inf)
        base, valid, cent, assign = self._prepare()
        q = torch.as_tensor(np.atleast_2d(np.asarray(queries, np.float32)),
                            device=self.device)
        kk = min(k, base.shape[0])
        if cent is None:
            scores, idx = brute_force_topk(q, base, valid, kk, self.metric)
        else:
            scores, idx = ivf_topk(q, base, valid, cent, assign, kk,
                                   min(self.nprobe, cent.shape[0]), self.metric)
        scores = scores.cpu().numpy().astype(np.float64)
        idx = idx.cpu().numpy()
        ids = self._ids[idx]
        ids = np.where(np.isfinite(scores), ids, -1)
        if kk < k:
            pad = k - kk
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
            scores = np.pad(scores, ((0, 0), (0, pad)), constant_values=-np.inf)
        return ids, scores
