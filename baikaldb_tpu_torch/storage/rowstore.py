"""OLTP row tier: memcomparable keys + MVCC memtable + transactions.

The port of ``baikaldb_tpu/storage/rowstore.py``.  The hot path lives in the
native C++ engine (native/engine.cpp, the port's own copy) behind ctypes;
this module adds:

- KeyCodec: (primary-key columns) -> order-preserving byte keys, batch via the
  native codec (the pure-Python codec of storage/_pykeys.py when no compiler
  exists, or when ``FORCE_PYTHON`` is set),
- RowCodec: row dict <-> value bytes (fixed-width fields + length-prefixed
  strings + null bitmap),
- RowTable: put/get/delete/scan with snapshot-isolation MVCC + WAL,
- Txn: buffered writes with row locks, atomic commit (one native write batch
  == one commit sequence), rollback, read-your-writes.

The key bytes, value bytes and WAL records are the JAX package's, byte for
byte, so the port recovers a WAL that package wrote.  The snapshot isolation
here is engine-internal (per-table write sequence numbers); cross-table
analytical snapshots are storage/mvcc.py's, and the two never exchange
timestamps.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Iterable, Optional

import numpy as np

from ..types import LType, Schema
from . import _pykeys
from ..native import get_lib as _native_lib

#: take the pure-Python codec and memtable even where the native engine
#: builds (the tests hold the two against each other)
FORCE_PYTHON = False


def get_lib():
    return None if FORCE_PYTHON else _native_lib()


def engine_name() -> str:
    """Which row engine a new RowTable uses: ``native`` or ``python``."""
    return "python" if get_lib() is None else "native"


class ConflictError(RuntimeError):
    """Write-write conflict (the reference returns lock-timeout here)."""


# ---------------------------------------------------------------------------
# key codec


class KeyCodec:
    """Encode PK column values into memcomparable keys."""

    def __init__(self, schema: Schema, key_columns: list[str]):
        self.schema = schema
        self.key_columns = key_columns
        self.kinds = []
        for k in key_columns:
            lt = schema.field(k).ltype
            if lt.is_integer or lt.is_temporal or lt is LType.BOOL:
                self.kinds.append("i64")
            elif lt.is_float:
                self.kinds.append("f64")
            elif lt is LType.STRING:
                self.kinds.append("bytes")
            else:
                raise TypeError(f"unsupported key type {lt}")

    def encode_rows(self, columns: list[np.ndarray],
                    valids: list[Optional[np.ndarray]]) -> list[bytes]:
        lib = get_lib()
        n = len(columns[0])
        if lib is None:
            return _pykeys.encode_rows(self.kinds, columns, valids, n)
        b = lib.bk_batch_new(n)
        try:
            for kind, col, valid in zip(self.kinds, columns, valids):
                vptr = None
                if valid is not None:
                    varr = np.ascontiguousarray(valid, dtype=np.uint8)
                    vptr = varr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
                if kind == "i64":
                    arr = np.ascontiguousarray(col, dtype=np.int64)
                    lib.bk_batch_append_i64(
                        b, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                        vptr, n)
                elif kind == "f64":
                    arr = np.ascontiguousarray(col, dtype=np.float64)
                    lib.bk_batch_append_f64(
                        b, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                        vptr, n)
                else:
                    blobs = [("" if s is None else str(s)).encode() for s in col]
                    data = b"".join(blobs)
                    offs = np.zeros(n + 1, np.int64)
                    np.cumsum([len(x) for x in blobs], out=offs[1:])
                    darr = np.frombuffer(data, dtype=np.uint8) if data else \
                        np.zeros(0, np.uint8)
                    darr = np.ascontiguousarray(darr)
                    lib.bk_batch_append_bytes(
                        b, darr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                        vptr, n)
            total = lib.bk_batch_total(b)
            out = np.zeros(total, np.uint8)
            offs = np.zeros(n + 1, np.int64)
            lib.bk_batch_dump(
                b, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            raw = out.tobytes()
            return [raw[offs[i]:offs[i + 1]] for i in range(n)]
        finally:
            lib.bk_batch_free(b)

    def encode_dicts(self, rows: list[dict]) -> list[bytes]:
        """``encode_one`` of each row, in one batch: the same bytes (a NULL
        key value encodes as 0 under an invalid bit, as there)."""
        if not rows:
            return []
        cols, valids = [], []
        for k, kind in zip(self.key_columns, self.kinds):
            vals = [r.get(k) for r in rows]
            valids.append(np.fromiter((v is not None for v in vals), bool, len(vals)))
            vals = [0 if v is None else v for v in vals]
            cols.append(np.asarray(vals) if kind in ("i64", "f64")
                        else np.asarray(vals, dtype=object))
        return self.encode_rows(cols, valids)

    def encode_one(self, values: dict) -> bytes:
        cols = []
        valids = []
        for k in self.key_columns:
            v = values.get(k)
            if isinstance(v, str):
                cols.append(np.asarray([v], dtype=object))
            else:
                cols.append(np.asarray([0 if v is None else v]))
            valids.append(np.asarray([v is not None], bool))
        return self.encode_rows(cols, valids)[0]


# ---------------------------------------------------------------------------
# row value codec


class RowCodec:
    """Serialize a full row to bytes: null bitmap + fixed/varlen fields."""

    def __init__(self, schema: Schema):
        self.schema = schema
        self.fields = schema.fields
        # each field's decoding, read once here: "i" an int64, "f" a float64,
        # "o" anything else (strings, dates, temporals)
        self._kinds = ["o" if f.ltype is LType.STRING or f.ltype is LType.DATE
                       or f.ltype.is_temporal else "f" if f.ltype.is_float else "i"
                       for f in self.fields]

    def encode(self, row: dict) -> bytes:
        nf = len(self.fields)
        bitmap = bytearray((nf + 7) // 8)
        parts = [b""]
        for i, f in enumerate(self.fields):
            v = row.get(f.name)
            if v is None:
                continue
            bitmap[i // 8] |= 1 << (i % 8)
            lt = f.ltype
            if lt is LType.STRING:
                bs = str(v).encode()
                parts.append(struct.pack("<I", len(bs)) + bs)
            elif lt.is_float:
                parts.append(struct.pack("<d", float(v)))
            elif lt is LType.DATE:
                parts.append(struct.pack("<q", _as_days(v)))
            elif lt.is_temporal:
                parts.append(struct.pack("<q", _as_micros(v)))
            else:
                parts.append(struct.pack("<q", int(v)))
        return bytes(bitmap) + b"".join(parts)

    def encode_columns(self, cols: dict, n: int) -> Optional[list[bytes]]:
        """``encode`` of ``n`` rows given as whole columns (name -> numpy
        array, or None where every value is NULL), as one fixed-width
        record array: the same bytes, without a Python call a row.  None
        when a column is a string or temporal one (variable width, or a
        conversion a value), so the caller encodes row by row."""
        nf = len(self.fields)
        bitmap = np.zeros((nf + 7) // 8, np.uint8)
        layout, values = [("bitmap", np.uint8, (len(bitmap),))], []
        for i, f in enumerate(self.fields):
            a = cols.get(f.name)
            if a is None:
                continue
            if f.ltype is LType.STRING or f.ltype is LType.DATE or f.ltype.is_temporal:
                return None
            bitmap[i // 8] |= 1 << (i % 8)
            dt = "<f8" if f.ltype.is_float else "<i8"
            layout.append((f.name, dt))
            values.append((f.name, np.asarray(a).astype(dt)))
        rec = np.empty(n, dtype=layout)
        rec["bitmap"] = bitmap
        for name, v in values:
            rec[name] = v
        buf, w = rec.tobytes(), rec.dtype.itemsize
        return [buf[i * w:(i + 1) * w] for i in range(n)]

    def decode(self, data: bytes) -> dict:
        nf = len(self.fields)
        nb = (nf + 7) // 8
        bitmap = data[:nb]
        pos = nb
        out = {}
        kinds = self._kinds
        for i, f in enumerate(self.fields):
            if not (bitmap[i // 8] >> (i % 8)) & 1:
                out[f.name] = None
                continue
            kind = kinds[i]
            if kind == "i":
                (out[f.name],) = struct.unpack_from("<q", data, pos)
                pos += 8
                continue
            if kind == "f":
                (out[f.name],) = struct.unpack_from("<d", data, pos)
                pos += 8
                continue
            lt = f.ltype
            if lt is LType.STRING:
                (ln,) = struct.unpack_from("<I", data, pos)
                pos += 4
                out[f.name] = data[pos:pos + ln].decode()
                pos += ln
            elif lt is LType.DATE:
                (d,) = struct.unpack_from("<q", data, pos)
                import datetime
                out[f.name] = datetime.date(1970, 1, 1) + datetime.timedelta(days=d)
                pos += 8
            else:                                 # a temporal
                (us,) = struct.unpack_from("<q", data, pos)
                import datetime
                out[f.name] = datetime.datetime(1970, 1, 1) + \
                    datetime.timedelta(microseconds=us)
                pos += 8
        return out


def _as_days(v) -> int:
    import datetime
    if isinstance(v, datetime.date):
        return (v - datetime.date(1970, 1, 1)).days
    return int(v)


def _as_micros(v) -> int:
    import datetime
    if isinstance(v, datetime.datetime):
        return int((v - datetime.datetime(1970, 1, 1)).total_seconds() * 1e6)
    return int(v)


# ---------------------------------------------------------------------------
# MVCC table + transactions


class RowTable:
    """One table's row tier (native memtable when available, python fallback)."""

    def __init__(self, schema: Schema, key_columns: list[str],
                 wal_path: str | None = None):
        self.schema = schema
        self.key_codec = KeyCodec(schema, key_columns)
        self.row_codec = RowCodec(schema)
        self._lib = get_lib()
        self._locks: dict[bytes, int] = {}
        self._lock_mu = threading.Lock()
        if self._lib is not None:
            self._t = self._lib.bk_table_new()
            if wal_path:
                if self._lib.bk_table_open_wal(self._t, wal_path.encode()) != 0:
                    raise OSError(f"cannot open WAL {wal_path}")
        else:
            self._t = _pykeys.PyTable(wal_path)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        t = getattr(self, "_t", None)
        if lib is not None and t is not None:
            lib.bk_table_free(t)

    # -- raw KV -----------------------------------------------------------
    def snapshot(self) -> int:
        if self._lib is None:
            return self._t.snapshot()
        return int(self._lib.bk_table_snapshot(self._t))

    def write_batch(self, ops: Iterable[tuple[int, bytes, bytes]]) -> int:
        """ops: (op, key, value); op 0=put 1=delete.  Atomic, one commit seq."""
        ops = list(ops)
        if not ops:
            return self.snapshot()
        if self._lib is None:
            return self._t.write_batch(ops)
        n = len(ops)
        oparr = np.asarray([o for o, _, _ in ops], np.uint8)
        keys = b"".join(k for _, k, _ in ops)
        koffs = np.zeros(n + 1, np.int64)
        np.cumsum([len(k) for _, k, _ in ops], out=koffs[1:])
        vals = b"".join(v for _, _, v in ops)
        voffs = np.zeros(n + 1, np.int64)
        np.cumsum([len(v) for _, _, v in ops], out=voffs[1:])
        karr = np.frombuffer(keys, np.uint8) if keys else np.zeros(0, np.uint8)
        varr = np.frombuffer(vals, np.uint8) if vals else np.zeros(0, np.uint8)
        P8 = ctypes.POINTER(ctypes.c_uint8)
        P64 = ctypes.POINTER(ctypes.c_int64)
        seq = self._lib.bk_table_write_batch(
            self._t, oparr.ctypes.data_as(P8),
            np.ascontiguousarray(karr).ctypes.data_as(P8),
            koffs.ctypes.data_as(P64),
            np.ascontiguousarray(varr).ctypes.data_as(P8),
            voffs.ctypes.data_as(P64), n)
        self._lib.bk_table_wal_sync(self._t)
        return int(seq)

    def get_raw(self, key: bytes, snapshot: int | None = None) -> bytes | None:
        if snapshot is None:
            snapshot = self.snapshot()
        if self._lib is None:
            return self._t.get(key, snapshot)
        cap = 4096
        need = ctypes.c_int64()
        P8 = ctypes.POINTER(ctypes.c_uint8)
        karr = np.frombuffer(key, np.uint8)
        out = np.zeros(cap, np.uint8)
        r = self._lib.bk_table_get(
            self._t, np.ascontiguousarray(karr).ctypes.data_as(P8), len(key),
            snapshot, out.ctypes.data_as(P8), cap, ctypes.byref(need))
        if r < 0:
            return None
        if need.value > cap:
            out = np.zeros(need.value, np.uint8)
            self._lib.bk_table_get(
                self._t, np.ascontiguousarray(karr).ctypes.data_as(P8), len(key),
                snapshot, out.ctypes.data_as(P8), need.value, ctypes.byref(need))
        return out[:need.value].tobytes()

    def scan_raw(self, lo: bytes = b"", hi: bytes = b"",
                 snapshot: int | None = None, limit: int = 0):
        if snapshot is None:
            snapshot = self.snapshot()
        if self._lib is None:
            return self._t.scan(lo, hi, snapshot, limit)
        P8 = ctypes.POINTER(ctypes.c_uint8)
        P64 = ctypes.POINTER(ctypes.c_int64)
        lo_a = np.frombuffer(lo, np.uint8) if lo else np.zeros(0, np.uint8)
        hi_a = np.frombuffer(hi, np.uint8) if hi else np.zeros(0, np.uint8)
        s = self._lib.bk_table_scan(
            self._t, np.ascontiguousarray(lo_a).ctypes.data_as(P8), len(lo),
            np.ascontiguousarray(hi_a).ctypes.data_as(P8), len(hi),
            snapshot, limit)
        try:
            n = self._lib.bk_scan_count(s)
            if n == 0:
                return []
            kt = self._lib.bk_scan_total_key_bytes(s)
            vt = self._lib.bk_scan_total_val_bytes(s)
            kout = np.zeros(max(kt, 1), np.uint8)
            vout = np.zeros(max(vt, 1), np.uint8)
            koffs = np.zeros(n + 1, np.int64)
            voffs = np.zeros(n + 1, np.int64)
            self._lib.bk_scan_dump(s, kout.ctypes.data_as(P8),
                                   koffs.ctypes.data_as(P64),
                                   vout.ctypes.data_as(P8),
                                   voffs.ctypes.data_as(P64))
            kraw, vraw = kout.tobytes(), vout.tobytes()
            ko, vo = koffs.tolist(), voffs.tolist()      # plain ints slice faster
            return [(kraw[ko[i]:ko[i + 1]], vraw[vo[i]:vo[i + 1]]) for i in range(n)]
        finally:
            self._lib.bk_scan_free(s)

    # -- row-level --------------------------------------------------------
    def put_row(self, row: dict) -> int:
        key = self.key_codec.encode_one(row)
        return self.write_batch([(0, key, self.row_codec.encode(row))])

    def get_row(self, key_values: dict, snapshot: int | None = None):
        raw = self.get_raw(self.key_codec.encode_one(key_values), snapshot)
        return None if raw is None else self.row_codec.decode(raw)

    def delete_row(self, key_values: dict) -> int:
        return self.write_batch([(1, self.key_codec.encode_one(key_values), b"")])

    def scan_rows(self, snapshot: int | None = None, limit: int = 0):
        return [self.row_codec.decode(v)
                for _, v in self.scan_raw(snapshot=snapshot, limit=limit)]

    def num_keys(self) -> int:
        if self._lib is None:
            return self._t.num_keys()
        return int(self._lib.bk_table_num_keys(self._t))

    def num_live_keys(self) -> int:
        """Keys whose newest version is live (tombstones excluded) — the
        size signal region split/merge policy keys off."""
        if self._lib is None:
            return self._t.num_live_keys()
        return int(self._lib.bk_table_num_live_keys(self._t))

    def gc(self, keep: int):
        if self._lib is None:
            self._t.gc(keep)
        else:
            self._lib.bk_table_gc(self._t, keep)

    # -- transactions ------------------------------------------------------
    def begin(self) -> "Txn":
        return Txn(self)

    def _acquire(self, txn_id: int, keys: list[bytes]):
        with self._lock_mu:
            for k in keys:
                holder = self._locks.get(k)
                if holder is not None and holder != txn_id:
                    raise ConflictError(f"row locked by txn {holder}")
            for k in keys:
                self._locks[k] = txn_id

    def _release(self, txn_id: int):
        with self._lock_mu:
            for k in [k for k, h in self._locks.items() if h == txn_id]:
                del self._locks[k]


_txn_ids = iter(range(1, 1 << 62))


class Txn:
    """Pessimistic transaction: locks on write, snapshot-isolation reads,
    atomic batch commit (reference: engine/transaction.h begin/commit/rollback
    + savepoints via rollback_to_point)."""

    def __init__(self, table: RowTable):
        self.table = table
        self.txn_id = next(_txn_ids)
        self.snapshot = table.snapshot()
        self._writes: dict[bytes, tuple[int, bytes]] = {}
        self._order: list[bytes] = []
        self._savepoints: list[int] = []
        self.active = True

    # read-your-writes over snapshot
    def get_row(self, key_values: dict):
        key = self.table.key_codec.encode_one(key_values)
        if key in self._writes:
            op, val = self._writes[key]
            return None if op == 1 else self.table.row_codec.decode(val)
        raw = self.table.get_raw(key, self.snapshot)
        return None if raw is None else self.table.row_codec.decode(raw)

    def put_row(self, row: dict):
        key = self.table.key_codec.encode_one(row)
        self.table._acquire(self.txn_id, [key])
        if key not in self._writes:
            self._order.append(key)
        self._writes[key] = (0, self.table.row_codec.encode(row))

    def put_rows(self, rows: list[dict]):
        """``put_row`` of many rows, their keys encoded in one batch."""
        kc = self.table.key_codec
        cols, valids = [], []
        for k in kc.key_columns:
            vals = [r.get(k) for r in rows]
            if any(isinstance(v, str) for v in vals):
                cols.append(np.asarray(vals, dtype=object))
            else:
                cols.append(np.asarray([0 if v is None else v for v in vals]))
            valids.append(np.asarray([v is not None for v in vals], bool))
        keys = kc.encode_rows(cols, valids)
        self.table._acquire(self.txn_id, keys)
        rc = self.table.row_codec
        for key, row in zip(keys, rows):
            if key not in self._writes:
                self._order.append(key)
            self._writes[key] = (0, rc.encode(row))

    def delete_row(self, key_values: dict):
        key = self.table.key_codec.encode_one(key_values)
        self.table._acquire(self.txn_id, [key])
        if key not in self._writes:
            self._order.append(key)
        self._writes[key] = (1, b"")

    def savepoint(self) -> int:
        # snapshot the whole buffered write set: a later write to a key first
        # written BEFORE the savepoint must roll back to the earlier value
        self._savepoints.append((dict(self._writes), list(self._order)))
        return len(self._savepoints) - 1

    def rollback_to(self, sp: int):
        writes, order = self._savepoints[sp]
        self._writes = dict(writes)
        self._order = list(order)
        del self._savepoints[sp:]

    def pending_ops(self) -> list[tuple[int, bytes, bytes]]:
        """The buffered write set in first-write order — what commit() would
        apply.  Used by the replicated tier to turn a SQL COMMIT into raft
        proposals instead of a local WAL batch."""
        return [(op, k, v) for k in self._order
                for op, v in (self._writes[k],)]

    def commit(self) -> int:
        if not self.active:
            raise RuntimeError("txn not active")
        try:
            seq = self.table.write_batch(
                [(op, k, v) for k in self._order
                 for op, v in (self._writes[k],)])
        finally:
            self.table._release(self.txn_id)
            self.active = False
        return seq

    def rollback(self):
        if self.active:
            self.table._release(self.txn_id)
            self.active = False
