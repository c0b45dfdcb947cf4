"""Device-resident columnar batches, held as torch tensors on one device.

The port of ``baikaldb_tpu/column/batch.py``.  A :class:`ColumnBatch` is an
ordered set of equal-length columns (one tensor each, plus an optional bool
validity tensor) and an optional bool row-selection mask ``sel``.  Filters
refine ``sel`` instead of shrinking the batch (late materialization), exactly
as in the JAX package, so every operator keeps the reference's semantics.

- Strings are int32 codes into host-side sorted dictionaries
  (column/dictionary.py).
- ``validity=None`` means all-valid.
- Every batch names its device; literals and scratch tensors that operators
  create go to that device, never to a default one.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from typing import Any, Optional

import numpy as np
import torch

from ..types import Field, LType, Schema
from .dictionary import NULL_CODE, Dictionary

_TORCH_OF_NP = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(lt: LType) -> torch.dtype:
    """Physical torch dtype of a logical type (the np_dtype of types.py)."""
    return _TORCH_OF_NP[lt.np_dtype]


def to_tensor(arr, device) -> torch.Tensor:
    """Host numpy array -> tensor on ``device`` (same dtype).  A read-only
    array (Arrow-backed) is copied, never aliased."""
    a = np.ascontiguousarray(arr)
    if not a.flags.writeable and torch.device(device).type == "cpu":
        a = a.copy()
    with warnings.catch_warnings():
        # a read-only array bound for the card is only read by the copy
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(a).to(device)


def dtype_max(dt: torch.dtype):
    return torch.finfo(dt).max if dt.is_floating_point else torch.iinfo(dt).max


def dtype_min(dt: torch.dtype):
    return torch.finfo(dt).min if dt.is_floating_point else torch.iinfo(dt).min


@dataclass
class Column:
    """One column: device data + optional validity + host metadata."""

    data: Any                       # torch tensor [N] (or 0-d for constants)
    validity: Optional[Any] = None  # torch bool [N] or None (all valid)
    ltype: LType = LType.INT64
    dictionary: Optional[Dictionary] = None  # host-side (strings only)

    def __len__(self) -> int:
        return self.data.shape[0]

    def valid_mask(self) -> torch.Tensor:
        if self.validity is None:
            return torch.ones(self.data.shape, dtype=torch.bool,
                              device=self.data.device)
        return self.validity

    @staticmethod
    def from_numpy(arr: np.ndarray, ltype: LType, validity: np.ndarray | None = None,
                   dictionary: Dictionary | None = None, device="cpu") -> "Column":
        return Column(to_tensor(arr, device),
                      None if validity is None else to_tensor(validity, device),
                      ltype, dictionary)

    def to_numpy(self):
        """-> (np data, np validity-or-None); strings stay as codes."""
        v = None if self.validity is None else self.validity.cpu().numpy()
        return self.data.cpu().numpy(), v


@dataclass
class ColumnBatch:
    """An ordered set of equal-length columns plus an optional selection mask.

    ``sel`` (bool [N] or None) marks live rows.  ``num_rows`` when set is a
    0-d tensor giving the count of live rows among the leading prefix (set by
    ``compact``); None means sel/all rows are authoritative.
    ``live_prefix`` promises that every live row sits in a leading prefix
    (set by ``pad_batch``).  ``device`` is where every tensor of the batch
    lives; it defaults to the first column's device.
    """

    names: tuple
    columns: list
    sel: Optional[Any] = None
    num_rows: Optional[Any] = None
    live_prefix: bool = False
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.device is None:
            if self.columns:
                self.device = self.columns[0].data.device
            elif self.sel is not None:
                self.device = self.sel.device
        if self.device is not None:
            self.device = torch.device(self.device)

    # -- accessors ------------------------------------------------------
    def __len__(self) -> int:
        return 0 if not self.columns else self.columns[0].data.shape[0]

    def column(self, name: str) -> Column:
        return self.columns[self.names.index(name)]

    def __contains__(self, name: str) -> bool:
        return name in self.names

    def sel_mask(self) -> torch.Tensor:
        if self.sel is None:
            return torch.ones(len(self), dtype=torch.bool, device=self.device)
        return self.sel

    def live_count(self) -> torch.Tensor:
        """Count of live rows, as a 0-d int32 tensor on the batch's device."""
        if self.num_rows is not None:
            return self.num_rows
        if self.sel is None:
            return torch.tensor(len(self), dtype=torch.int32, device=self.device)
        return self.sel.sum().to(torch.int32)

    # -- functional updates --------------------------------------------
    def and_sel(self, mask) -> "ColumnBatch":
        sel = mask if self.sel is None else self.sel & mask
        return ColumnBatch(self.names, self.columns, sel, None, device=self.device)

    def gather(self, idx, valid=None) -> "ColumnBatch":
        """Row gather with clipped indices; ``valid`` optionally masks the
        output rows' validity."""
        n = len(self)
        cols = []
        if n == 0:
            # nothing to gather from: zero-filled rows, marked by ``valid``
            for c in self.columns:
                data = torch.zeros((idx.shape[0],) + tuple(c.data.shape[1:]),
                                   dtype=c.data.dtype, device=self.device)
                v = valid
                if c.validity is not None:
                    v = torch.zeros(idx.shape[0], dtype=torch.bool,
                                    device=self.device)
                cols.append(replace(c, data=data, validity=v))
            return ColumnBatch(self.names, cols, None, None, device=self.device)
        idx = idx.to(torch.int64).clamp(0, n - 1)
        for c in self.columns:
            data = c.data[idx]
            if c.validity is not None:
                v = c.validity[idx]
                if valid is not None:
                    v = v & valid
            else:
                v = valid
            cols.append(replace(c, data=data, validity=v))
        return ColumnBatch(self.names, cols, None, None, device=self.device)

    def schema(self) -> Schema:
        return Schema(tuple(Field(n, c.ltype) for n, c in zip(self.names, self.columns)))

    # -- host <-> device ------------------------------------------------
    @staticmethod
    def from_arrow(table, device) -> "ColumnBatch":
        """Build from a pyarrow Table/RecordBatch on ``device`` (string
        columns dictionary-encoded, see column/dictionary.py)."""
        import pyarrow as pa

        names, cols = [], []
        for fld in table.schema:
            arr = table.column(fld.name)
            names.append(fld.name)
            if not _is_string(fld.type):
                cols.append(_column_of_chunks(getattr(arr, "chunks", [arr]), fld.type, device))
                continue
            # a string column needs one dictionary across its chunks
            if hasattr(arr, "combine_chunks"):
                arr = arr.combine_chunks()
            if pa.types.is_dictionary(arr.type):
                cols.append(_encoded_column(arr, device))
                continue
            data, validity, ltype, d = _arrow_to_numpy(arr, fld.type)
            cols.append(Column.from_numpy(data, ltype, validity, d, device))
        return ColumnBatch(tuple(names), cols, device=device)

    @staticmethod
    def from_numpy(names, columns, sel=None, num_rows=None, device="cpu",
                   live_prefix: bool = False) -> "ColumnBatch":
        """Carry a batch's host state across into the port on ``device``.

        ``columns`` holds one ``(data, validity, ltype, dictionary_values)``
        tuple per name: numpy arrays (validity and dictionary values may be
        None) and a logical type, given as an ``LType`` of either package or
        its string value.  ``sel`` and ``num_rows`` are as in the batch."""
        cols = []
        for data, validity, lt, dvals in columns:
            lt = LType(getattr(lt, "value", lt))
            d = None if dvals is None else Dictionary(np.asarray(dvals, dtype=str))
            cols.append(Column.from_numpy(np.asarray(data, lt.np_dtype), lt,
                                          None if validity is None
                                          else np.asarray(validity, bool),
                                          d, device))
        sel_t = None if sel is None else to_tensor(np.asarray(sel, bool), device)
        nr = None if num_rows is None else torch.tensor(int(num_rows), dtype=torch.int32,
                                                        device=device)
        return ColumnBatch(tuple(names), cols, sel_t, nr, live_prefix, device=device)

    def to_arrow(self):
        """Densify + decode back to a pyarrow Table (device -> host egress)."""
        import pyarrow as pa

        sel = None if self.sel is None else self.sel.cpu().numpy()
        n = None if self.num_rows is None else int(self.num_rows)
        arrays, fields = [], []
        for name, c in zip(self.names, self.columns):
            data, valid = c.to_numpy()
            if n is not None:
                data = data[:n]
                valid = None if valid is None else valid[:n]
            elif sel is not None:
                data = data[sel]
                valid = None if valid is None else valid[sel]
            arrays.append(_column_to_arrow(c, data, valid))
            fields.append(pa.field(name, arrays[-1].type))
        return pa.table(arrays, schema=pa.schema(fields))

    def to_pylist(self) -> list[dict]:
        return self.to_arrow().to_pylist()


# ----------------------------------------------------------------------
_ARROW_LTYPE = None


def _arrow_ltype_map():
    global _ARROW_LTYPE
    if _ARROW_LTYPE is None:
        import pyarrow as pa

        _ARROW_LTYPE = {
            pa.bool_(): LType.BOOL,
            pa.int8(): LType.INT8,
            pa.int16(): LType.INT16,
            pa.int32(): LType.INT32,
            pa.int64(): LType.INT64,
            pa.uint32(): LType.UINT32,
            pa.uint64(): LType.UINT64,
            pa.float32(): LType.FLOAT32,
            pa.float64(): LType.FLOAT64,
            pa.date32(): LType.DATE,
            pa.timestamp("us"): LType.DATETIME,
        }
    return _ARROW_LTYPE


def _arrow_to_numpy(arr, typ):
    """Host half of the Arrow -> device codec: -> (np data, np validity-or-
    None, ltype, dictionary-or-None), with the JAX package's null-fill
    discipline."""
    import pyarrow as pa
    import pyarrow.compute as pc

    if pa.types.is_dictionary(arr.type):
        values, codes = _dictionary_parts(arr)
        d, remap = _renumbering(values,
                                np.bincount(codes, minlength=len(values) + 1)[:len(values)] > 0)
        data = remap[codes]
        return data, data != NULL_CODE if arr.null_count else None, LType.STRING, d
    if _is_string(typ):
        d, codes = Dictionary.from_arrow(arr)
        validity = codes != NULL_CODE if arr.null_count else None
        return codes, validity, LType.STRING, d
    if pa.types.is_decimal(typ):
        arr = pc.cast(arr, pa.float64())
        typ = pa.float64()
    if pa.types.is_date32(typ):
        ltype = LType.DATE
        work = arr.cast(pa.int32())
    elif pa.types.is_timestamp(typ):
        ltype = LType.DATETIME
        work = arr.cast(pa.timestamp("us")).cast(pa.int64())
    else:
        ltype = _arrow_ltype_map().get(typ)
        if ltype is None:
            raise TypeError(f"unsupported arrow type {typ}")
        work = arr
    if arr.null_count:
        validity = ~np.asarray(arr.is_null())
        if not pa.types.is_floating(work.type):
            # fill nulls at the Arrow level: to_numpy renders a null-bearing
            # int array as float64+NaN, which corrupts int64 beyond 2^53
            fill = False if pa.types.is_boolean(work.type) else 0
            work = pc.fill_null(work, fill)
        np_data = work.to_numpy(zero_copy_only=False)
        if np_data.dtype.kind == "f":
            np_data = np.nan_to_num(np_data)
        return np_data.astype(ltype.np_dtype, copy=False), validity, ltype, None
    np_data = work.to_numpy(zero_copy_only=False)
    return np_data.astype(ltype.np_dtype, copy=False), None, ltype, None


def _dictionary_parts(arr) -> tuple[np.ndarray, np.ndarray]:
    """An Arrow dictionary array's values (str) and its rows' int32 codes,
    a NULL row's code one past the last value."""
    values = arr.dictionary.to_numpy(zero_copy_only=False).astype(str)
    idx = arr.indices.fill_null(0) if arr.null_count else arr.indices
    codes = idx.to_numpy(zero_copy_only=False).astype(np.int32, copy=False)
    if arr.null_count:
        codes = np.where(np.asarray(arr.is_null()), np.int32(len(values)), codes)
    return values, codes


def _renumbering(values: np.ndarray, used: np.ndarray) -> tuple[Dictionary, np.ndarray]:
    """The dictionary of the ``used`` entries of ``values``, distinct and
    sorted (an Arrow dictionary may hold a value twice, or unused), and each
    entry's code in it, ``NULL_CODE`` appended for the NULL rows: what
    ``Dictionary.from_arrow`` gives the same strings decoded."""
    uniq, inv = np.unique(values, return_inverse=True)
    inv = inv.reshape(-1)
    keep = np.zeros(len(uniq), bool)
    keep[inv[used]] = True
    remap = np.append((np.cumsum(keep) - 1)[inv], NULL_CODE).astype(np.int32)
    return Dictionary(uniq[keep]), remap


def _encoded_column(arr, device) -> Column:
    """A dictionary-encoded Arrow string array -> a STRING column on
    ``device``: the rows' codes are counted and renumbered there, and the
    host touches the dictionary alone, never a string a row."""
    from ..analysis.runtime import host_read

    values, host_codes = _dictionary_parts(arr)
    codes = to_tensor(host_codes, device)
    used = host_read(torch.bincount(codes, minlength=len(values) + 1)[:len(values)] > 0)
    d, remap = _renumbering(values, used.numpy())
    out = torch.index_select(to_tensor(remap, device), 0, codes)
    return Column(out, out != NULL_CODE if arr.null_count else None, LType.STRING, d)


def _is_string(typ) -> bool:
    import pyarrow as pa

    return pa.types.is_string(typ) or pa.types.is_large_string(typ) or \
        pa.types.is_dictionary(typ)


def _column_of_chunks(chunks, typ, device) -> Column:
    """A numeric column of Arrow chunks (a table of many regions): each
    chunk goes to ``device`` as it is and the pieces join there, so the host
    never concatenates the column."""
    import pyarrow as pa

    parts = [_arrow_to_numpy(c, typ) for c in (chunks or [pa.array([], type=typ)])]
    data = _join([to_tensor(p[0], device) for p in parts])
    validity = None
    if any(p[1] is not None for p in parts):
        validity = _join([to_tensor(np.ones(len(p[0]), bool) if p[1] is None else p[1], device)
                          for p in parts])
    return Column(data, validity, parts[0][2], None)


def _join(pieces: list) -> torch.Tensor:
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def _column_to_arrow(c: Column, data: np.ndarray, valid: np.ndarray | None):
    import pyarrow as pa

    if c.ltype is LType.STRING:
        if c.dictionary is None:
            return pa.array(data.astype(np.int32), type=pa.int32())
        strings = c.dictionary.decode(data.astype(np.int32))
        if valid is not None:
            strings[~valid] = None
        return pa.array(strings, type=pa.string())
    mask = None if valid is None else ~valid
    if c.ltype is LType.DATE:
        return pa.array(data.astype("int32"), type=pa.date32(), mask=mask)
    if c.ltype in (LType.DATETIME, LType.TIMESTAMP):
        return pa.array(data.astype("int64"), type=pa.timestamp("us"), mask=mask)
    return pa.array(data, mask=mask)


def bucket_capacity(n: int, minimum: int = 1) -> int:
    """Smallest power-of-two >= max(n, minimum, 1)."""
    return 1 << (max(int(n), int(minimum), 1) - 1).bit_length()


def pad_batch(batch: ColumnBatch, capacity: int) -> ColumnBatch:
    """Pad to ``capacity`` rows with dead rows (``sel=False`` tail), filled
    with zeros / False / code 0.  When the input had no sel the result is
    marked ``live_prefix``."""
    n = len(batch)
    if capacity < n:
        raise ValueError(f"pad_batch: capacity {capacity} < {n} rows")
    dev = batch.device
    prefix = batch.sel is None
    if capacity == n:
        if batch.sel is None:
            return ColumnBatch(batch.names, batch.columns,
                               torch.ones(n, dtype=torch.bool, device=dev),
                               batch.num_rows, live_prefix=True, device=dev)
        return batch
    pad = capacity - n
    cols = []
    for c in batch.columns:
        data = torch.cat([c.data, torch.zeros((pad,) + tuple(c.data.shape[1:]),
                                              dtype=c.data.dtype, device=dev)])
        validity = None
        if c.validity is not None:
            validity = torch.cat([c.validity,
                                  torch.zeros(pad, dtype=torch.bool, device=dev)])
        cols.append(Column(data, validity, c.ltype, c.dictionary))
    sel = torch.cat([batch.sel_mask(), torch.zeros(pad, dtype=torch.bool, device=dev)])
    return ColumnBatch(batch.names, cols, sel, None, live_prefix=prefix, device=dev)


def concat_batches(batches: list[ColumnBatch]) -> ColumnBatch:
    """Concatenate same-schema batches (densified) along rows."""
    if not batches:
        raise ValueError("concat_batches needs at least one batch")
    first = batches[0]
    dev = first.device
    cols = []
    for i in range(len(first.names)):
        parts_d = [b.columns[i].data for b in batches]
        data = torch.cat(parts_d)
        validity = None
        if any(b.columns[i].validity is not None for b in batches):
            validity = torch.cat([b.columns[i].valid_mask() for b in batches])
        cols.append(replace(first.columns[i], data=data, validity=validity))
    sel = None
    if any(b.sel is not None for b in batches):
        sel = torch.cat([b.sel_mask() for b in batches])
    return ColumnBatch(first.names, cols, sel, None, device=dev)
