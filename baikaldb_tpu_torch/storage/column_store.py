"""Minimal column store: one table's Arrow data plus its device image.

The port of the parts of ``baikaldb_tpu/storage/column_store.py`` that a
SELECT needs.  A :class:`TableStore` holds the table's rows as one Arrow
table on the host, stages one device batch per table version on its device
(table-wide string dictionaries), and serves the host column statistics
that the planner reads: ``min``/``max``/``dict_size`` for the dense
group-by and dense-join choices, and the histogram/MCV/ndv payload of
index/stats for selectivity and join ordering.  ``_zone_scalar`` canonicalizes
zone-map bounds for the streamed scan's chunk pruning
(storage/streamchunks.py).  Regions, WAL, MVCC, partitions, secondary
indexes and the cold tier's segments are not ported.
"""

from __future__ import annotations

import datetime
import threading

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from ..column.batch import ColumnBatch
from ..index.stats import collect
from ..meta.catalog import TableInfo
from ..types import LType, Schema
from ..utils.flags import FLAGS


def schema_to_arrow(schema: Schema) -> pa.Schema:
    m = {
        LType.BOOL: pa.bool_(), LType.INT8: pa.int8(), LType.INT16: pa.int16(),
        LType.INT32: pa.int32(), LType.INT64: pa.int64(),
        LType.UINT32: pa.uint32(), LType.UINT64: pa.uint64(),
        LType.FLOAT32: pa.float32(), LType.FLOAT64: pa.float64(),
        LType.DECIMAL: pa.float64(), LType.DATE: pa.date32(),
        LType.DATETIME: pa.timestamp("us"), LType.TIMESTAMP: pa.timestamp("us"),
        LType.STRING: pa.string(),
    }
    return pa.schema([pa.field(f.name, m[f.ltype], nullable=f.nullable)
                      for f in schema.fields])


def _coerce(table: pa.Table, schema: pa.Schema) -> pa.Table:
    if table.schema == schema:
        return table
    cols = []
    for f in schema:
        if f.name not in table.column_names:
            cols.append(pa.nulls(table.num_rows, f.type))
        else:
            cols.append(table.column(f.name).cast(f.type))
    return pa.table(cols, schema=schema)


def _zone_scalar(x, ltype):
    """Normalize a zone-map bound or predicate literal to one comparable
    number in the COLUMN's unit (DATE: epoch days; DATETIME/TIMESTAMP: epoch
    seconds; numerics: as-is).  None = unbounded/incomparable — pruning
    treats it as 'keep the chunk'.  The JAX store's function of the same
    name, copied."""
    if x is None:
        return None
    if isinstance(x, str):
        try:
            if ltype is LType.DATE:
                d = datetime.date.fromisoformat(x[:10])
                return (d - datetime.date(1970, 1, 1)).days
            if ltype.is_temporal:
                dt = datetime.datetime.fromisoformat(x)
                return dt.replace(tzinfo=datetime.timezone.utc).timestamp()
        except ValueError:
            return None
        return None
    if isinstance(x, datetime.datetime):
        return x.replace(tzinfo=datetime.timezone.utc).timestamp()
    if isinstance(x, datetime.date):
        if ltype.is_temporal and ltype is not LType.DATE:
            return datetime.datetime(x.year, x.month, x.day,
                                     tzinfo=datetime.timezone.utc).timestamp()
        return (x - datetime.date(1970, 1, 1)).days
    if isinstance(x, bool) or isinstance(x, (int, float)):
        if ltype is LType.DATE and isinstance(x, int):
            return x                       # already epoch days
        return x
    return None


class TableStore:
    """Host rows + the device batch of the current version."""

    def __init__(self, info: TableInfo, device: torch.device):
        self.info = info
        self.device = device
        self.arrow_schema = schema_to_arrow(info.schema)
        self._data = self.arrow_schema.empty_table()
        self._mutations = 0
        self._lock = threading.Lock()
        self._device_batch = None        # (version, ColumnBatch)
        self._sharded = None             # (version, Mesh, ShardedBatch)
        self._stats: tuple = (-1, {})    # (version, {column: stats})

    @property
    def num_rows(self) -> int:
        return self._data.num_rows

    @property
    def version(self) -> int:
        """Monotonic mutation counter: device image and stats key on it."""
        return self._mutations

    def snapshot(self) -> pa.Table:
        return self._data

    def insert_arrow(self, table: pa.Table) -> None:
        """Bulk append (``Session.load_arrow``)."""
        table = _coerce(table, self.arrow_schema)
        with self._lock:
            self._data = pa.concat_tables([self._data, table]).combine_chunks()
            self._mutations += 1

    def insert_rows(self, rows: list[dict]) -> None:
        """Append ``INSERT ... VALUES`` rows (dicts keyed by column)."""
        cols = {f.name: [r.get(f.name) for r in rows] for f in self.arrow_schema}
        self.insert_arrow(pa.table(cols, schema=self.arrow_schema))

    def truncate(self) -> None:
        """TRUNCATE: every row goes.  The version moves on, so the device
        image, the statistics and the streamed chunk set rebuild."""
        with self._lock:
            self._data = self.arrow_schema.empty_table()
            self._mutations += 1
            self._device_batch = None
            self._sharded = None

    def release(self) -> None:
        """Drop the device image, its sharded copy and the chunk set (DROP
        TABLE / DATABASE)."""
        with self._lock:
            self._device_batch = None
            self._sharded = None
            self._stream_chunks = None

    def device_table_batch(self) -> ColumnBatch:
        """Whole-table batch on the store's device, cached per version."""
        with self._lock:
            return self._image()

    def _image(self) -> ColumnBatch:
        """``device_table_batch`` with the lock held."""
        v = self._mutations
        if self._device_batch is None or self._device_batch[0] != v:
            self._device_batch = None     # free the old image first
            self._device_batch = (v, ColumnBatch.from_arrow(self._data, self.device))
        return self._device_batch[1]

    def sharded_batch(self, mesh):
        """The table row-sharded across ``mesh`` (parallel/mesh.shard_batch):
        the region-to-store placement analog, each shard one horizontal slice
        padded to an equal length.  Cached per version and mesh beside the
        device image, and freed with it."""
        from ..parallel.mesh import shard_batch

        with self._lock:
            v = self._mutations
            hit = self._sharded
            if hit is None or hit[0] != v or hit[1] != mesh:
                self._sharded = None          # free the old shards first
                self._sharded = (v, mesh, shard_batch(self._image(), mesh))
            return self._sharded[2]

    def column_stats(self, column: str) -> dict:
        """Host-side statistics for planner decisions, as the JAX package
        computes them: ``dict_size`` for strings, ``min``/``max`` for
        integer, BOOL and DATE columns, and the histogram/MCV/ndv payload of
        index/stats for every column."""
        with self._lock:
            v = self._mutations
            if self._stats[0] != v:
                self._stats = (v, {})
            cache = self._stats[1]
            if column in cache:
                return cache[column]
            data = self._data
        col = data.column(column)
        f = self.info.schema.field(column)
        st: dict = {}
        if f.ltype is LType.STRING:
            d = self.device_table_batch().column(column).dictionary
            st["dict_size"] = 0 if d is None else len(d)
        elif data.num_rows:
            mm = pc.min_max(col).as_py()
            mn, mx = mm["min"], mm["max"]
            if hasattr(mn, "toordinal") and not hasattr(mn, "hour"):
                epoch = datetime.date(1970, 1, 1)
                mn, mx = (mn - epoch).days, (mx - epoch).days
            if isinstance(mn, int) or f.ltype.is_integer or f.ltype is LType.DATE:
                st["min"], st["max"] = mn, mx
        st.update(_histogram_stats(col, f) or {})
        cache[column] = st
        return st


def _histogram_stats(col, f) -> dict | None:
    """Equi-depth histogram + MCVs of one column (index/stats), or None when
    the flag is off or the column is empty."""
    if not FLAGS.histogram_stats:
        return None
    n_total = len(col)
    if n_total == 0:
        return None
    vals = pc.drop_null(col).combine_chunks().to_numpy(zero_copy_only=False)
    kind = None
    if f.ltype is LType.STRING:
        vals = np.asarray(vals, dtype=object)
        numeric = False
    else:
        if vals.dtype.kind == "M":        # date/datetime
            if f.ltype is LType.DATE:
                vals = vals.astype("datetime64[D]")
                kind = "date"
            else:
                vals = vals.astype("datetime64[us]")
                kind = "datetime"
            vals = vals.astype(np.int64)
        elif vals.dtype.kind == "O":
            return None                   # no numeric view of the column
        numeric = True
    st = collect(vals, n_total, col.null_count, numeric)
    if kind:
        st["kind"] = kind
    return st
