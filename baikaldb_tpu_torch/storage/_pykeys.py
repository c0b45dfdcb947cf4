"""Pure-Python codec and memtable of the row engine: the same key bytes,
WAL records and MVCC semantics as ``native/engine.cpp``, used when no C++
toolchain is available (the port's copy of ``baikaldb_tpu/storage/_pykeys.py``)."""

from __future__ import annotations

import struct
import threading


def _enc_i64(v: int) -> bytes:
    return struct.pack(">Q", (v & 0xFFFFFFFFFFFFFFFF) ^ 0x8000000000000000)


def _enc_f64(v: float) -> bytes:
    bits = struct.unpack("<Q", struct.pack("<d", v))[0]
    if bits & 0x8000000000000000:
        bits = ~bits & 0xFFFFFFFFFFFFFFFF
    else:
        bits |= 0x8000000000000000
    return struct.pack(">Q", bits)


def _enc_bytes(s: bytes) -> bytes:
    return s.replace(b"\x00", b"\x00\xff") + b"\x00\x00"


def encode_rows(kinds, columns, valids, n) -> list[bytes]:
    out = [bytearray() for _ in range(n)]
    for kind, col, valid in zip(kinds, columns, valids):
        for i in range(n):
            if valid is not None and not valid[i]:
                out[i] += b"\x00"
                continue
            out[i] += b"\x01"
            if kind == "i64":
                out[i] += _enc_i64(int(col[i]))
            elif kind == "f64":
                out[i] += _enc_f64(float(col[i]))
            else:
                out[i] += _enc_bytes(("" if col[i] is None else str(col[i])).encode())
    return [bytes(b) for b in out]


class PyTable:
    def __init__(self, wal_path=None):
        self._rows: dict[bytes, list[tuple[int, bool, bytes]]] = {}
        self._next_seq = 1
        self._mu = threading.Lock()
        self._wal = None
        if wal_path:
            try:
                with open(wal_path, "rb") as f:
                    data = f.read()
                pos = 0
                while pos + 25 <= len(data):
                    op = data[pos]
                    seq, kl, vl = struct.unpack_from("<QQQ", data, pos + 1)
                    pos += 25
                    k = data[pos:pos + kl]
                    pos += kl
                    v = data[pos:pos + vl]
                    pos += vl
                    self._rows.setdefault(k, []).append((seq, op == 1, v))
                    self._next_seq = max(self._next_seq, seq + 1)
            except FileNotFoundError:
                pass
            self._wal = open(wal_path, "ab")

    def snapshot(self) -> int:
        with self._mu:
            return self._next_seq - 1

    def write_batch(self, ops) -> int:
        with self._mu:
            seq = self._next_seq
            self._next_seq += 1
            for op, k, v in ops:
                self._rows.setdefault(k, []).append((seq, op == 1, v))
                if self._wal:
                    self._wal.write(bytes([op]) +
                                    struct.pack("<QQQ", seq, len(k), len(v)) + k + v)
            if self._wal:
                self._wal.flush()
            return seq

    def _visible(self, versions, snapshot):
        best = None
        for seq, tomb, v in versions:
            if seq <= snapshot:
                best = (tomb, v)
        if best is None or best[0]:
            return None
        return best[1]

    def get(self, key: bytes, snapshot: int):
        with self._mu:
            vs = self._rows.get(key)
            return None if vs is None else self._visible(vs, snapshot)

    def scan(self, lo: bytes, hi: bytes, snapshot: int, limit: int):
        with self._mu:
            out = []
            for k in sorted(self._rows):
                if lo and k < lo:
                    continue
                if hi and k >= hi:
                    break
                v = self._visible(self._rows[k], snapshot)
                if v is None:
                    continue
                out.append((k, v))
                if limit and len(out) >= limit:
                    break
            return out

    def gc(self, keep: int):
        with self._mu:
            for k in list(self._rows):
                vs = self._rows[k]
                first = 0
                for i, (seq, _, _) in enumerate(vs):
                    if seq <= keep:
                        first = i
                vs[:] = vs[first:]
                if len(vs) == 1 and vs[0][1] and vs[0][0] <= keep:
                    del self._rows[k]

    def num_keys(self) -> int:
        with self._mu:
            return len(self._rows)

    def num_live_keys(self) -> int:
        with self._mu:
            return sum(1 for vs in self._rows.values()
                       if vs and not vs[-1][1])
