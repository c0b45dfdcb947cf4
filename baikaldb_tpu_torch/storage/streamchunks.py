"""Chunked columnar segments for out-of-core streaming scans.

The port of ``baikaldb_tpu/storage/streamchunks.py``.  ``device_table_batch``
bounds a scan by what fits on the card at once; a chunk set breaks that
bound:

- a table snapshot is encoded ONCE through the shared host codec
  (column/batch._arrow_to_numpy) — table-wide string dictionaries, so
  per-chunk partial aggregates merge by code — then sliced into
  fixed-capacity chunks;
- each chunk persists as a Parquet segment (plain pages, uncompressed) in
  the coldfs tier when one is configured (the ``coldfs.get`` failpoint then
  fires mid-scan, and reads retry with backoff and full jitter), in host
  memory otherwise;
- per-chunk zone maps (min/max/has_null, canonicalized exactly like
  ``column_store._zone_scalar``) let selective predicates skip whole chunks
  before any host->device transfer;
- every chunk loads as a batch of the same layout: fixed capacity,
  explicit ``sel = arange < live``, validity exactly on the columns the
  whole table has it.

Loading is where the port differs from the reference.  XLA needed one
static pytree for its jitted fold; here the question is how a chunk gets
onto the card while the previous one folds.  A :class:`ChunkLoader` (one
per fold) owns a ring of ``SLOTS`` chunk-sized pinned host buffers and a
side CUDA stream for the copies:

- the stager thread decodes a segment into the next ring slot (``stage``);
- the folding thread issues ``copy_(..., non_blocking=True)`` of the slot
  into a fresh device buffer on the copy stream and records an event
  (``upload``), one chunk ahead of the fold, so the copy overlaps the
  previous chunk's fold;
- the fold waits on that event on the compute stream (``wait``), never on
  the host;
- the device buffer, made on the copy stream and read on the compute
  stream, gets ``record_stream(compute)``, so the caching allocator cannot
  hand its memory out while the fold still reads it;
- a slot is rewritten only after the event of the copy out of it has
  completed.

On a CPU device the same ring runs with ordinary host buffers and a copy
per chunk, and no streams or events.  The chunk set caches on the
TableStore keyed by (version, chunk_rows), like the device image.
"""

from __future__ import annotations

import io
import os
import random
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..column.batch import Column, ColumnBatch, _arrow_to_numpy
from ..types import LType
from ..utils import metrics
from ..utils.flags import FLAGS
from .column_store import _zone_scalar


class StreamChunkSet:
    """One table version sliced into fixed-capacity encoded chunks."""

    def __init__(self, table_key: str, version: int, snapshot, fs, device):
        import pyarrow.compute as pc

        self.table_key = table_key
        self.version = version
        self.fs = fs
        self.device = torch.device(device)
        cr = max(1, int(FLAGS.streaming_chunk_rows))
        self.capacity = cr
        nrows = snapshot.num_rows
        self.total_rows = nrows
        self.n_chunks = max(1, -(-nrows // cr))
        self.live = [max(0, min(cr, nrows - i * cr))
                     for i in range(self.n_chunks)]
        self.ltypes: dict = {}
        self._dicts: dict = {}
        self._has_validity: dict = {}
        self._dtypes: dict = {}
        self.zones: dict = {}        # col -> [ (zmin, zmax, has_null) | None ]
        self._ram: dict = {}         # chunk id -> parquet bytes fallback
        names, encoded, zoned = [], {}, []
        for fld in snapshot.schema:
            arr = snapshot.column(fld.name).combine_chunks()
            data, validity, ltype, d = _arrow_to_numpy(arr, fld.type)
            names.append(fld.name)
            self.ltypes[fld.name] = ltype
            self._dicts[fld.name] = d
            # validity presence is decided over the whole table, so every
            # chunk has the same layout even when the NULLs sit in one chunk
            self._has_validity[fld.name] = validity is not None
            self._dtypes[fld.name] = data.dtype
            encoded[fld.name] = (data, validity)
            if (ltype.is_integer or ltype.is_float or ltype is LType.DATE
                    or ltype.is_temporal):
                zoned.append((fld.name, arr, ltype))
        self.names = tuple(names)

        def build(i: int) -> list:
            """Chunk ``i``: its zone per zoned column, and its segment."""
            zones = []
            for _name, arr, ltype in zoned:
                col = arr.slice(i * cr, self.live[i])
                if not self.live[i]:
                    zones.append(None)
                elif col.null_count == len(col):
                    zones.append((None, None, True))
                else:
                    mm = pc.min_max(col).as_py()
                    zones.append((_zone_scalar(mm["min"], ltype),
                                  _zone_scalar(mm["max"], ltype),
                                  col.null_count > 0))
            self._persist(i, encoded)
            return zones

        # Arrow's min_max and the Parquet writer release the interpreter
        # lock: the chunks build in parallel (the futures' results are read,
        # so a failure raises here)
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            per_chunk = list(ex.map(build, range(self.n_chunks)))
        for j, (name, _arr, _lt) in enumerate(zoned):
            self.zones[name] = [z[j] for z in per_chunk]
        # the encoded full-table arrays are NOT retained: from here on a
        # chunk's bytes live in coldfs (or the RAM fallback) until loaded

    # -- persistence -------------------------------------------------------
    def _seg_name(self, i: int) -> str:
        return f"stream/{self.table_key}/v{self.version}/c{i}"

    def _persist(self, i: int, encoded: dict) -> None:
        import pyarrow as pa
        import pyarrow.parquet as pq

        lo = i * self.capacity
        arrays, names = [], []
        for name in self.names:
            data, validity = encoded[name]
            arrays.append(pa.array(data[lo:lo + self.live[i]]))
            names.append(name)
            if validity is not None:
                arrays.append(pa.array(validity[lo:lo + self.live[i]]))
                names.append(f"__v_{name}")
        buf = io.BytesIO()
        # plain pages: every streamed query decodes every chunk, and
        # dictionary pages and snappy cost ~9x the write and ~2x the read on
        # numeric columns (the zone maps are kept apart, so no statistics)
        pq.write_table(pa.table(arrays, names=names), buf, compression="none",
                       use_dictionary=False, write_statistics=False)
        payload = buf.getvalue()
        if self.fs is None:
            self._ram[i] = payload
            return
        name = self._seg_name(i)
        self.fs.put(name, payload)
        if not self.fs.exists(name):
            # coldfs.put dropped the bytes (manifest-without-segment): keep
            # the RAM copy so the scan cannot lose the chunk
            self._ram[i] = payload

    def _read_segment(self, i: int) -> bytes:
        if self.fs is None or i in self._ram:
            return self._ram[i]
        name = self._seg_name(i)
        backoff = max(0.0, float(FLAGS.stream_backoff_ms)) / 1000.0
        attempts = max(0, int(FLAGS.stream_retry_max)) + 1
        rng = random.Random()           # plain jitter, NOT the chaos RNG
        last = None
        for attempt in range(attempts):
            try:
                return self.fs.get(name)
            except (FileNotFoundError, OSError) as e:
                last = e
                if attempt + 1 >= attempts:
                    break
                metrics.stream_retries.add(1)
                time.sleep(rng.uniform(0.0, backoff))
                backoff *= 2.0
        raise last

    def decode(self, i: int) -> dict:
        """Chunk ``i``'s columns on the host: name -> (data, validity or
        None), ``live[i]`` rows each (validity all-true where the table has
        validity and this chunk has no NULL)."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        # one file, read on this thread: lighter than read_table's dataset path
        t = pq.ParquetFile(pa.BufferReader(self._read_segment(i))).read(use_threads=False)
        out = {}
        for name in self.names:
            data = t.column(name).to_numpy(zero_copy_only=False)
            validity = None
            if self._has_validity[name]:
                if f"__v_{name}" in t.column_names:
                    validity = t.column(f"__v_{name}").to_numpy(
                        zero_copy_only=False)
                else:
                    validity = np.ones(self.live[i], dtype=bool)
            out[name] = (data, validity)
        return out

    # -- pruning -------------------------------------------------------------
    def pruned(self, ranges: dict) -> list[int]:
        """Chunk ids whose zone maps can satisfy every [lo, hi] constraint
        (conservative — any uncertainty keeps the chunk; an all-NULL chunk
        can satisfy no comparison)."""
        keep = []
        for i in range(self.n_chunks):
            if not self.live[i]:
                continue
            alive = True
            for col, (lo, hi) in (ranges or {}).items():
                zones = self.zones.get(col)
                if zones is None or zones[i] is None:
                    continue
                zmin, zmax, _ = zones[i]
                if zmin is None:
                    alive = False
                    break
                lt = self.ltypes[col]
                lo_c = _zone_scalar(lo, lt)
                hi_c = _zone_scalar(hi, lt)
                if lo_c is not None and zmax < lo_c:
                    alive = False
                    break
                if hi_c is not None and zmin > hi_c:
                    alive = False
                    break
            if alive:
                keep.append(i)
        return keep


@dataclass
class StagedChunk:
    """One loaded chunk: its batch on the set's device, the bytes moved
    host->device and (on CUDA) the event of its copy."""
    batch: ColumnBatch
    nbytes: int
    ready: Optional[object] = None


def _aligned(n: int) -> int:
    return -(-n // 16) * 16


class ChunkLoader:
    """One fold's staging of a chunk set onto the set's device (see the
    module docstring).  A chunk travels as one byte image: every column's
    data, then its validity, then ``sel``, each region 16-byte aligned, so
    a chunk is one host->device copy and its columns are views of one
    device buffer.

    - ``stage`` (the stager thread) decodes chunk ``i`` into the next ring
      slot.  It makes no CUDA call, and its copies hold the interpreter
      lock instead of releasing and re-taking it per column: a thread that
      re-takes the lock while the folding thread runs Python waits up to
      the interpreter's switch interval (5 ms) each time;
    - ``upload`` (the folding thread) issues the slot's copy on the copy
      stream into a fresh device buffer, records the copy's event (the
      slot's fence) and returns the batch; the fold uploads chunk i+1
      before it folds chunk i, so the copy overlaps that fold;
    - ``wait`` orders the compute stream after a chunk's copy."""

    # the chunk being decoded, the one queued for the folding thread, and
    # the one uploaded last, whose copy may still be in flight
    SLOTS = 3

    def __init__(self, cs: StreamChunkSet):
        self.cs = cs
        self.device = cs.device
        self.cuda = self.device.type == "cuda"
        self.compute = torch.cuda.current_stream(self.device) if self.cuda else None
        self.copy = torch.cuda.Stream(self.device) if self.cuda else None
        cap = cs.capacity
        off = 0
        # (name, numpy dtype, torch dtype, data offset, validity offset)
        self._layout = []
        for name in cs.names:
            dt = np.dtype(cs._dtypes[name])
            data_off = off
            off += _aligned(cap * dt.itemsize)
            valid_off = None
            if cs._has_validity[name]:
                valid_off = off
                off += _aligned(cap)
            tdt = torch.from_numpy(np.zeros(0, dt)).dtype
            self._layout.append((name, dt, tdt, data_off, valid_off))
        self._sel_off = off
        self.nbytes = off + _aligned(cap)
        self._slots: list = [None] * self.SLOTS
        self._fences: list = [None] * self.SLOTS
        self._slot_live: list = [None] * self.SLOTS
        self._loads = 0

    def stage(self, i: int, dead: bool = False) -> int:
        """Decode chunk ``i`` into the next ring slot (host only); -> the
        slot.  ``dead``: every row's sel is false (the empty-input stand-in
        when pruning removed every chunk)."""
        cs = self.cs
        host = cs.decode(i)
        k = self._loads % self.SLOTS
        self._loads += 1
        fence = self._fences[k]
        if fence is not None:
            fence.synchronize()          # the copy out of this slot is done
        if self._slots[k] is None:
            self._slots[k] = torch.zeros(self.nbytes, dtype=torch.uint8,
                                         pin_memory=self.cuda)
        buf = self._slots[k].numpy()
        mv = memoryview(buf)
        cap, n = cs.capacity, cs.live[i]
        for name, dt, _tdt, data_off, valid_off in self._layout:
            d, v = host[name]
            raw = memoryview(np.ascontiguousarray(d, dtype=dt)).cast("B")
            mv[data_off:data_off + raw.nbytes] = raw
            if n < cap:
                buf[data_off + n * dt.itemsize:data_off + cap * dt.itemsize] = 0
            if valid_off is not None:
                mv[valid_off:valid_off + n] = memoryview(
                    np.ascontiguousarray(v, dtype=bool)).cast("B")
                if n < cap:
                    buf[valid_off + n:valid_off + cap] = 0
        live = 0 if dead else n
        if self._slot_live[k] != live:
            buf[self._sel_off:self._sel_off + live] = 1
            buf[self._sel_off + live:self._sel_off + cap] = 0
            self._slot_live[k] = live
        return k

    def upload(self, slot: int) -> StagedChunk:
        """Copy ring slot ``slot`` to the device and build its batch."""
        cs, cap = self.cs, self.cs.capacity
        src = self._slots[slot]
        if self.cuda:
            with torch.cuda.stream(self.copy):
                dev = torch.empty(self.nbytes, dtype=torch.uint8, device=self.device)
                dev.copy_(src, non_blocking=True)
                # made on the copy stream, read on the compute stream: the
                # allocator must not hand it out before the fold has read it
                dev.record_stream(self.compute)
                ready = torch.cuda.Event()
                ready.record(self.copy)
            self._fences[slot] = ready
        else:
            dev, ready = src.clone(), None

        def view(off, dtype, itemsize):
            return dev[off:off + cap * itemsize].view(dtype)

        cols = []
        for name, dt, tdt, data_off, valid_off in self._layout:
            data = view(data_off, tdt, dt.itemsize)
            valid = None if valid_off is None else view(valid_off, torch.bool, 1)
            cols.append(Column(data, valid, cs.ltypes[name], cs._dicts[name]))
        sel = view(self._sel_off, torch.bool, 1)
        batch = ColumnBatch(cs.names, cols, sel, None, live_prefix=True, device=self.device)
        return StagedChunk(batch, self.nbytes, ready)

    def wait(self, chunk: StagedChunk) -> None:
        """Order the compute stream after the chunk's copy (no host wait)."""
        if chunk.ready is not None:
            self.compute.wait_event(chunk.ready)


class ChunkSource:
    """One execution's view of a chunk set: the chunk ids this query's
    predicate zone maps kept.  This is what rides the batches dict in a
    ScanNode's slot — exec/streaming.py recognizes it and takes the
    chunk-folded path."""

    def __init__(self, chunks: StreamChunkSet, keep: list[int]):
        self.chunks = chunks
        self.keep = keep

    @property
    def names(self) -> tuple:
        return self.chunks.names


def chunk_set(store, table_key: str, fs) -> StreamChunkSet:
    """The store's chunk set for its current version (rebuilt only when the
    version or chunk size moves)."""
    with store._lock:
        v = store.version
        key = (v, max(1, int(FLAGS.streaming_chunk_rows)))
        cached = getattr(store, "_stream_chunks", None)
        if cached is not None and getattr(store, "_stream_chunks_key",
                                          None) == key:
            return cached
        store._stream_chunks = None       # free the old chunk set first
        cs = StreamChunkSet(table_key, v, store.snapshot(), fs, store.device)
        store._stream_chunks = cs
        store._stream_chunks_key = key
        return cs
