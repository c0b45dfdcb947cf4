"""External cold-storage filesystem (the AFS stand-in).

A copy of ``ExternalFS`` from ``baikaldb_tpu/storage/coldfs.py``: the posix
backend of the reference's external-filesystem abstraction (atomic puts of
immutable segment files, named reads, listing and deletes).  The streamed
scan (storage/streamchunks.py) keeps its Parquet chunk segments here when a
cold directory is configured.  Reads and writes pass the ``coldfs.get`` /
``coldfs.put`` failpoints (chaos/failpoint.py).
"""

from __future__ import annotations

import os

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
