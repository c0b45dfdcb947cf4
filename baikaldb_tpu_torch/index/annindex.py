"""SQL-reachable ANN access path.

The port of ``baikaldb_tpu/index/annindex.py``.  The reference keeps a
per-region faiss index (IVF-Flat / HNSW) with a scalar payload and a delete
bitmap, chosen by the planner for vector queries.  Here exact distance is
the default (a brute-force scan is a matrix product over the component
columns), and this module is the sublinear path: when a table declares an
ANN INDEX on a vector column and a SELECT is shaped ``ORDER BY
l2_distance(vec, '[..]') LIMIT k``, the scan is REDUCED to the IVF candidate
set (``ops/vector.ivf_search_host`` over trained centroids, on the host as
in the JAX package) and the unchanged plan re-ranks those candidates
exactly — WHERE filters and expressions apply as usual because the
candidate rows flow through the normal pipeline.

Index lifecycle: trained lazily from the store's current snapshot; on data
change the centroids are KEPT and rows re-assigned (one product on the
store's device) while the row count drifts less than ``ann_rebuild_drift``,
beyond which k-means retrains on the store's device.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ..expr.ast import Call, ColRef, Lit
from ..obs import trace
from ..sql.stmt import SelectStmt
from ..utils.flags import FLAGS, define

define("ann_nprobe", 8, "IVF clusters probed per ANN query")
define("ann_oversample", 4,
       "candidate factor over LIMIT k for the exact re-rank stage")
define("ann_max_k", 1024, "largest LIMIT served through the ANN path")
define("ann_min_rows", 4096,
       "below this row count the fused brute-force scan wins")
define("ann_rebuild_drift", 0.2,
       "fraction of row-count drift that triggers k-means retraining "
       "(smaller drifts only re-assign rows to existing centroids)")
define("ann_where_widen", 8,
       "WHERE-filtered ANN queries multiply oversample and nprobe by this: "
       "the filter drops candidates AFTER reduction, so the pre-filter pool "
       "must run deeper or LIMIT k silently under-fills; once the widened "
       "pool approaches the table the scan falls back to brute force")
define("ann_nlist", 0, "IVF cluster count; 0 = sqrt(n)")

# distance fn -> (ops.vector metric, ascending order expected)
_DIST_OPS = {"l2_distance": ("l2", True),
             "cosine_distance": ("cosine", True),
             "inner_product": ("ip", False)}


def ann_index_for(info, col: str):
    for ix in info.indexes:
        if ix.kind == "ann" and ix.columns and ix.columns[0] == col:
            return ix
    return None


def parse_vec_literal(v, dim: int) -> Optional[tuple]:
    """The query vector of a literal, or None (the exact scan runs and the
    planner reports it).  The matcher's grammar is the JAX package's: a
    string in brackets with commas (``'[1,2,3]'``) or a list or tuple of
    ``dim`` numbers.  ``plan/planner.parse_vector`` reads more forms
    (``'1 2 3'``, ``'1,2,3'``) for INSERT and the distance functions, where
    both packages take them; here they leave the query to the exact scan,
    as in the reference."""
    if isinstance(v, str):
        s = v.strip()
        if not (s.startswith("[") and s.endswith("]")):
            return None
        try:
            vals = tuple(float(x) for x in s[1:-1].split(",") if x.strip())
        except ValueError:
            return None
    elif isinstance(v, (list, tuple)):
        try:
            vals = tuple(float(x) for x in v)
        except (TypeError, ValueError):
            return None
    else:
        return None
    return vals if len(vals) == dim else None


def _reads_beyond_topk(e) -> bool:
    """Window functions / aggregates / subqueries read rows OUTSIDE the
    top-k candidate set — reducing the scan under them changes their
    answer."""
    from ..expr.ast import AggCall, Subquery, WindowCall

    if e is None:
        return False
    if isinstance(e, (WindowCall, AggCall, Subquery)):
        return True
    return any(_reads_beyond_topk(a) for a in getattr(e, "args", ()))


def match_ann_query(stmt: SelectStmt, info, label: str):
    """(index, vec_col, metric, qvec, k) when the statement is the ANN
    shape over ``info``, else None.  WHERE is allowed (filters re-apply on
    the candidate set); anything that changes which rows are 'top' is
    not."""
    if (stmt.joins or stmt.ctes or stmt.union is not None or stmt.distinct
            or stmt.group_by or stmt.having is not None
            or stmt.limit is None or len(stmt.order_by) != 1):
        return None
    if any(_reads_beyond_topk(e) for e in
           [it.expr for it in stmt.items] + [stmt.where]
           + [o.expr for o in stmt.order_by]):
        return None
    if stmt.limit + stmt.offset > int(FLAGS.ann_max_k):
        return None
    vector_cols = (info.options or {}).get("vector_cols") or {}
    if not vector_cols:
        return None
    oe = stmt.order_by[0]
    e = oe.expr
    if not (isinstance(e, Call) and e.op in _DIST_OPS and len(e.args) == 2):
        return None
    metric, want_asc = _DIST_OPS[e.op]
    if oe.asc != want_asc:
        return None
    col_e, lit_e = e.args
    if isinstance(lit_e, ColRef):
        col_e, lit_e = lit_e, col_e
    if not (isinstance(col_e, ColRef) and isinstance(lit_e, Lit)):
        return None
    if col_e.table is not None and col_e.table != label:
        return None
    dim = vector_cols.get(col_e.name)
    if dim is None:
        return None
    ix = ann_index_for(info, col_e.name)
    if ix is None:
        return None
    qvec = parse_vec_literal(lit_e.value, int(dim))
    if qvec is None:
        return None
    return ix, col_e.name, metric, qvec, stmt.limit + stmt.offset


def snapshot_matrix(snap, col: str, dim: int) -> tuple[np.ndarray, np.ndarray]:
    """The ``[n, dim]`` float32 matrix of vector column ``col`` from its
    component columns, and the rows' validity (a NULL or NaN component
    makes the row invalid; its components read 0)."""
    cols = np.empty((dim, snap.num_rows), np.float32)
    for i in range(dim):
        cols[i] = snap.column(f"__{col}_{i}").to_numpy(zero_copy_only=False)
    # one blocked transpose: filling the row-major matrix a column at a
    # time strides through it, a cache miss a value
    m = torch.from_numpy(cols).T.contiguous().numpy()
    valid = ~np.isnan(m).any(axis=1)
    return np.nan_to_num(m, copy=False), valid


class _AnnState:
    """Trained state in the packed (cluster-sorted) layout of
    ops.vector.pack_ivf: probing gathers contiguous ranges."""

    __slots__ = ("version", "matrix", "valid", "centroids", "order",
                 "starts", "counts", "max_count", "built_rows", "norms",
                 "lock")

    def __init__(self):
        self.lock = threading.Lock()
        self.version = -1
        self.matrix = None          # [n, d] float32, cluster-sorted
        self.valid = None           # [n] bool, cluster-sorted
        self.centroids = None
        self.order = None           # sorted pos -> snapshot pos
        self.starts = None
        self.counts = None
        self.max_count = 1
        self.built_rows = 0
        self.norms = None           # cached ||row||^2, cluster-sorted


class AnnManager:
    """Per-Database cache of trained ANN state, keyed by (table, column)."""

    def __init__(self):
        self._states: dict = {}
        self._mu = threading.Lock()

    def _refresh(self, st: _AnnState, store, col: str, dim: int) -> bool:
        """Bring state to the store's current version; False when the
        table is too small for the ANN path."""
        from ..ops.vector import _scores, kmeans, pack_ivf

        if st.version == store.version and st.matrix is not None:
            return True
        snap = store.snapshot()
        n = snap.num_rows
        if n < int(FLAGS.ann_min_rows):
            st.version = store.version
            st.matrix = None
            return False
        # the spans split a (re)build: the host matrix, the device
        # training or re-assignment, the packed layout
        with trace.span("ann.snapshot", rows=n):
            m, valid = snapshot_matrix(snap, col, dim)
        drift = abs(n - st.built_rows) / max(st.built_rows, 1)
        if st.centroids is None or drift > float(FLAGS.ann_rebuild_drift):
            nc = int(FLAGS.ann_nlist) or max(16, int(np.sqrt(n)))
            nc = min(nc, max(n // 8, 1))
            with trace.span("ann.kmeans", clusters=nc):
                st.centroids, assign = kmeans(m, nc, device=store.device)
            st.built_rows = n
        else:
            # drift within budget: keep the trained centroids, re-assign
            # every row (one [n, c] product — the faiss add() analog)
            with trace.span("ann.assign"):
                s = _scores(torch.as_tensor(m, device=store.device),
                            torch.as_tensor(st.centroids, device=store.device),
                            "l2", "f32")
                assign = torch.argmax(s, dim=1).cpu().numpy()
                del s
        with trace.span("ann.pack"):
            order, st.starts, st.counts, st.max_count = pack_ivf(
                m, assign, n_clusters=len(st.centroids))
            st.order = order
            st.matrix = m[order]
            st.valid = valid[order]
            st.norms = (st.matrix * st.matrix).sum(1)
        st.version = store.version
        return True

    def candidates(self, table_key: str, store, col: str, dim: int,
                   qvec: tuple, metric: str, k: int,
                   filtered: bool = False):
        """(positions ndarray, nprobe) into the store snapshot row order,
        or None when brute force should run instead.

        ``filtered``: the statement carries a WHERE clause, which re-applies
        AFTER the candidate reduction — a selective filter over a plain
        k*oversample pool silently returns fewer than LIMIT rows.  The pool
        deepens by ann_where_widen (oversample AND nprobe); when the widened
        pool approaches the table size the sublinear path concedes and the
        exact brute-force scan runs (correctness beats sublinearity).

        Best-effort, like every post-filtered ANN engine: selectivity is
        unknown at reduction time, so a filter more selective than roughly
        1/ann_where_widen of the table can still under-fill LIMIT on large
        tables.  Raise ann_where_widen (or drop the ANN index) when a
        workload's filters are sharper than that."""
        from ..ops.vector import ivf_search_host

        # _mu only guards the registry; training/search serialize PER
        # (table, column) — k-means on one table must not stall ANN
        # queries on already-trained tables in other connection threads
        with self._mu:
            st = self._states.get((table_key, col))
            if st is None:
                st = self._states[(table_key, col)] = _AnnState()
        with st.lock:
            if not self._refresh(st, store, col, dim):
                return None
            n = st.matrix.shape[0]
            widen = max(1, int(FLAGS.ann_where_widen)) if filtered else 1
            k2 = min(n, max(k * int(FLAGS.ann_oversample) * widen,
                            64 * widen))
            if filtered and 2 * k2 >= n:
                return None     # pool ~ the table: brute force is exact
            nprobe = min(int(FLAGS.ann_nprobe) * widen,
                         st.centroids.shape[0])
            scores, idx = ivf_search_host(
                np.asarray(qvec, np.float32), st.matrix, st.valid,
                st.centroids, st.starts, st.counts, k2, nprobe, metric,
                norms_sorted=st.norms)
            pos = st.order[idx[np.isfinite(scores)]]
            return pos, nprobe

    def forget(self, table_key: str) -> None:
        """Drop the trained state of a table (DROP TABLE / DATABASE)."""
        with self._mu:
            for key in [k for k in self._states if k[0] == table_key]:
                del self._states[key]


def manager(db) -> AnnManager:
    m = getattr(db, "_ann_manager", None)
    if m is None:
        m = db._ann_manager = AnnManager()
    return m
