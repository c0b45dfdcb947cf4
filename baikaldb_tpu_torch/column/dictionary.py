"""Host-side sorted string dictionaries.

TPUs cannot chase variable-length string bytes; the reference's columnar path
keeps strings as Arrow utf8 arrays and runs string kernels on CPU
(``src/expr/arrow_string_function.cpp``).  The TPU-native design instead
dictionary-encodes every string column at ingest:

- the *codes* (int32) live on device and flow through every kernel;
- the *dictionary* (a sorted, de-duplicated numpy array of strings) stays on
  the host, attached to the column metadata.

Because the dictionary is sorted:
- ``=  <  <= >  >=`` against a literal compile to integer comparisons on codes
  (via host-side binary search for the literal's code / insertion point);
- ``LIKE 'prefix%'`` compiles to a code-range test;
- arbitrary string functions (LENGTH, UPPER, SUBSTR, regexp) are evaluated once
  per *distinct* value on the host, producing a lookup table gathered by code on
  device — O(|dict|) host work instead of O(N) row work.

Cross-column string ops (joins, group-bys spanning two tables) remap one side's
codes through a host-computed translation table (`translate_codes`).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

NULL_CODE = np.int32(-1)
MEMO_MAX = 16                # host tables kept per dictionary (least recent out)
_MEMO_LOCK = threading.Lock()


class Dictionary:
    """An immutable sorted dictionary for one string column."""

    __slots__ = ("values", "_id", "_ft_index", "_ft_state", "_hash_cache",
                 "_fp", "_memo")

    def __init__(self, values: np.ndarray):
        # values must be sorted unique unicode/objects
        self.values = values
        self._id = id(values)
        self._ft_index = None   # lazily-built fulltext index (index/fulltext)
        self._ft_state = None   # per-dictionary BM25 state (fulltext)
        self._hash_cache = None
        self._fp = None         # lazy content fingerprint (see __eq__)
        self._memo: OrderedDict = OrderedDict()   # key -> host table (memo)

    def memo(self, key, build):
        """``build()``, kept for this dictionary under ``key``.  A string
        function or LIKE pattern is host work over every distinct value;
        without a compiled-plan cache each query would redo it.  At most
        ``MEMO_MAX`` tables stay, the least recently used going first, so
        ad-hoc patterns do not grow it.  Two threads may both build; the
        first to store wins and every caller gets it."""
        with _MEMO_LOCK:
            if key in self._memo:
                self._memo.move_to_end(key)
                return self._memo[key]
        table = build()
        with _MEMO_LOCK:
            table = self._memo.setdefault(key, table)
            self._memo.move_to_end(key)
            while len(self._memo) > MEMO_MAX:
                self._memo.popitem(last=False)
        return table

    # -- value equality ---------------------------------------------------
    # Content equality via a cached digest: two rebuilds of one column's
    # dictionary with the same distinct values compare equal in O(1) after
    # the first hash, and a changed value set does not.
    def _fingerprint(self) -> bytes:
        if self._fp is None:
            import hashlib

            h = hashlib.blake2b(digest_size=16)
            arr = self.values
            h.update(str(len(arr)).encode())
            if arr.dtype.kind == "U":
                h.update(str(arr.dtype).encode())
                h.update(arr.tobytes())
            else:
                for v in arr:
                    b = str(v).encode("utf-8")
                    h.update(len(b).to_bytes(4, "little"))
                    h.update(b)
            self._fp = h.digest()
        return self._fp

    def __eq__(self, other):
        if self is other:
            return True
        if not isinstance(other, Dictionary):
            return NotImplemented
        return self._fingerprint() == other._fingerprint()

    def __hash__(self):
        return hash(self._fingerprint())

    # -- construction ---------------------------------------------------
    @staticmethod
    def encode(strings) -> tuple["Dictionary", np.ndarray]:
        """Encode an iterable of python strings (None allowed) -> (dict, codes)."""
        arr = np.asarray(["" if s is None else s for s in strings], dtype=object)
        mask = np.asarray([s is None for s in strings], dtype=bool)
        uniq, inv = np.unique(arr.astype(str), return_inverse=True)
        codes = inv.astype(np.int32)
        codes[mask] = NULL_CODE
        return Dictionary(uniq), codes

    @staticmethod
    def from_arrow(arr) -> tuple["Dictionary", np.ndarray]:
        """Encode a pyarrow string/dictionary Array -> (dict, codes)."""
        import pyarrow.compute as pc

        d = pc.dictionary_encode(arr.combine_chunks() if hasattr(arr, "combine_chunks") else arr)
        if hasattr(d, "chunks"):
            d = d.combine_chunks()
        values = np.asarray(d.dictionary.to_pylist(), dtype=str)
        null_mask = np.asarray(d.indices.is_null())
        if len(values) == 0:
            # all-NULL column: empty dictionary, every code NULL
            return Dictionary(values), np.full(len(arr), NULL_CODE, np.int32)
        codes = d.indices.fill_null(0).to_numpy(zero_copy_only=False).astype(np.int32)
        order = np.argsort(values, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        codes = np.where(null_mask, NULL_CODE, rank[np.clip(codes, 0, None)]).astype(np.int32)
        return Dictionary(values[order]), codes

    # -- lookups --------------------------------------------------------
    def __len__(self) -> int:
        return len(self.values)

    def code_of(self, s: str) -> int | None:
        """Exact code of s, or None if absent."""
        i = int(np.searchsorted(self.values, s))
        if i < len(self.values) and self.values[i] == s:
            return i
        return None

    def lower_bound(self, s: str) -> int:
        return int(np.searchsorted(self.values, s, side="left"))

    def upper_bound(self, s: str) -> int:
        return int(np.searchsorted(self.values, s, side="right"))

    def prefix_range(self, prefix: str) -> tuple[int, int]:
        """[lo, hi) code range of values starting with prefix (LIKE 'p%')."""
        lo = self.lower_bound(prefix)
        # upper sentinel: max code point so astral-plane chars stay in range
        hi = int(np.searchsorted(self.values, prefix + "\U0010FFFF", side="right"))
        return lo, hi

    def map_values(self, fn, out_dtype) -> np.ndarray:
        """Host-evaluate fn over distinct values -> device gather table."""
        return np.asarray([fn(v) for v in self.values], dtype=out_dtype)

    def match_mask(self, pred) -> np.ndarray:
        """Boolean per-code table for an arbitrary string predicate."""
        return np.asarray([bool(pred(v)) for v in self.values], dtype=bool)

    def value_hashes(self) -> np.ndarray:
        """Per-code uint32 hash of the VALUE (not the code).  Equal strings
        hash equal across different dictionaries, so shuffle partitioning of
        string keys (parallel/shuffle.py) co-locates matches from two tables
        without a host-side dictionary merge; collisions only affect load
        balance, never correctness."""
        if self._hash_cache is None:
            import zlib

            self._hash_cache = np.asarray(
                [zlib.crc32(v.encode("utf-8")) for v in self.values],
                dtype=np.uint32)
        return self._hash_cache

    def decode(self, codes: np.ndarray) -> np.ndarray:
        out = np.empty(len(codes), dtype=object)
        valid = codes >= 0
        out[valid] = self.values[codes[valid]]
        out[~valid] = None
        return out


def merge(a: Dictionary, b: Dictionary) -> tuple[Dictionary, np.ndarray, np.ndarray]:
    """Merge two dictionaries -> (merged, remap_a, remap_b).

    remap_x maps old codes of x into the merged dictionary; used to align two
    string columns before a device-side join/compare (the TPU analog of the
    reference comparing raw bytes in hash-join keys, src/exec/joiner.cpp).
    """
    values = np.union1d(a.values, b.values)
    remap_a = np.searchsorted(values, a.values).astype(np.int32)
    remap_b = np.searchsorted(values, b.values).astype(np.int32)
    return Dictionary(values), remap_a, remap_b


def translate_codes(codes: np.ndarray, remap: np.ndarray) -> np.ndarray:
    out = np.where(codes >= 0, remap[np.clip(codes, 0, None)], NULL_CODE)
    return out.astype(np.int32)
