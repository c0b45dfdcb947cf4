"""External cold-storage filesystem (the AFS stand-in).

A copy of ``baikaldb_tpu/storage/coldfs.py``: ``ExternalFS`` is the posix
backend of the reference's external-filesystem abstraction (atomic puts of
immutable segment files, named reads, listing and deletes), and
``segment_bytes`` / ``segment_rows`` the Parquet codec of the replicated
tier's cold segments, whose manifest replicates through the region groups
(raft/cluster.py CMD_COLD): bytes on the external FS, truth in consensus.
The streamed scan (storage/streamchunks.py) keeps its Parquet chunk
segments here too when a cold directory is configured.  Reads and writes
pass the ``coldfs.get`` / ``coldfs.put`` failpoints (chaos/failpoint.py).
"""

from __future__ import annotations

import io
import os

import pyarrow as pa
import pyarrow.parquet as pq

from ..chaos import failpoint
from ..obs import trace


class ExternalFS:
    """Posix-dir backend; the API is the AFS-client shape (open/read/write/
    list/remove) so a real AFS/HDFS client can slot in behind it."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, name: str) -> str:
        safe = name.replace("/", "_")
        return os.path.join(self.root, safe)

    def put(self, name: str, data: bytes) -> None:
        """Atomic immutable write (segments are never modified in place)."""
        with trace.span("coldfs.put", file=name, nbytes=len(data)):
            if failpoint.ENABLED:
                if failpoint.hit("coldfs.put", file=name):
                    return      # drop: the bytes never land
            tmp = self._path(name) + f".tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(name))

    def get(self, name: str) -> bytes:
        with trace.span("coldfs.get", file=name):
            if failpoint.ENABLED:
                if failpoint.hit("coldfs.get", file=name):
                    raise FileNotFoundError(
                        f"coldfs.get dropped by failpoint: {name}")
            with open(self._path(name), "rb") as f:
                return f.read()

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))

    def list(self) -> list[str]:
        return sorted(f for f in os.listdir(self.root)
                      if not f.endswith(".tmp") and ".tmp." not in f)

    def delete(self, name: str) -> None:
        try:
            os.remove(self._path(name))
        except FileNotFoundError:
            pass


def segment_bytes(rows: list[dict], arrow_schema: pa.Schema) -> bytes:
    """Serialize row dicts (incl. __rowid / __del) into one immutable
    Parquet segment."""
    # deltas, not final rows: __del markers carry NULLs in every data
    # column, so the segment schema is fully nullable regardless of the
    # table's declared constraints
    arrow_schema = pa.schema([pa.field(f.name, f.type, nullable=True)
                              for f in arrow_schema])
    arrays = []
    for f in arrow_schema:
        vals = [r.get(f.name) for r in rows]
        if pa.types.is_boolean(f.type):
            # the row codec decodes BOOL as 0/1 ints
            vals = [None if v is None else bool(v) for v in vals]
        arrays.append(pa.array(vals, type=f.type))
    table = pa.Table.from_arrays(arrays, schema=arrow_schema)
    buf = io.BytesIO()
    pq.write_table(table, buf)
    return buf.getvalue()


def segment_rows(data: bytes) -> list[dict]:
    return pq.read_table(io.BytesIO(data)).to_pylist()
