"""ctypes binding over the native Raft core (native/raft.cpp).

The port's copy of ``baikaldb_tpu/raft/core.py``; the library builds through
native/__init__.py ``build_library`` (a content-hashed name under ``_build/``,
written to a temporary name and moved into place, so concurrent first users
never race on one file).

The core is a pure deterministic state machine: the host calls tick() on its
own clock, feeds inbound messages to receive(), and drains three output
channels — outbound messages, committed entries, and snapshot-install
events.  Determinism (seeded election timeouts, no internal clocks/threads)
is what makes elections and partitions unit-testable, which the reference's
braft cannot do without real time and sockets."""

from __future__ import annotations

import ctypes
import os
import threading
from dataclasses import dataclass
from typing import Optional

from ..native import build_library

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native", "raft.cpp")

_lock = threading.Lock()
_lib = None
_err: Optional[str] = None

NOOP, DATA, CONFIG = 0, 1, 2
SNAPSHOT_KIND = 255
FOLLOWER, CANDIDATE, LEADER = 0, 1, 2


def _sig(lib):
    c = ctypes
    P8 = c.POINTER(c.c_uint8)
    P64 = c.POINTER(c.c_int64)
    lib.rf_new.restype = c.c_void_p
    lib.rf_new.argtypes = [c.c_int64, P64, c.c_int, c.c_uint64, c.c_int,
                           c.c_int, c.c_int]
    lib.rf_free.argtypes = [c.c_void_p]
    lib.rf_tick.argtypes = [c.c_void_p]
    lib.rf_receive.argtypes = [c.c_void_p, P8, c.c_int64]
    lib.rf_propose.restype = c.c_int64
    lib.rf_propose.argtypes = [c.c_void_p, c.c_uint8, P8, c.c_int64]
    for name in ("rf_role", "rf_peer_count", "rf_learner_count",
                 "rf_committed_current_term"):
        getattr(lib, name).restype = c.c_int
        getattr(lib, name).argtypes = [c.c_void_p]
    lib.rf_learners.argtypes = [c.c_void_p, P64]
    for name in ("rf_term", "rf_commit_index", "rf_last_index",
                 "rf_first_index"):
        getattr(lib, name).restype = c.c_uint64
        getattr(lib, name).argtypes = [c.c_void_p]
    lib.rf_leader.restype = c.c_int64
    lib.rf_leader.argtypes = [c.c_void_p]
    lib.rf_peers.argtypes = [c.c_void_p, P64]
    lib.rf_out_count.restype = c.c_int64
    lib.rf_out_count.argtypes = [c.c_void_p]
    lib.rf_out_dest.restype = c.c_int64
    lib.rf_out_dest.argtypes = [c.c_void_p, c.c_int64]
    lib.rf_out_size.restype = c.c_int64
    lib.rf_out_size.argtypes = [c.c_void_p, c.c_int64]
    lib.rf_out_copy.argtypes = [c.c_void_p, c.c_int64, P8]
    lib.rf_out_clear.argtypes = [c.c_void_p]
    lib.rf_commit_count.restype = c.c_int64
    lib.rf_commit_count.argtypes = [c.c_void_p]
    lib.rf_commit_index_at.restype = c.c_uint64
    lib.rf_commit_index_at.argtypes = [c.c_void_p, c.c_int64]
    lib.rf_commit_kind.restype = c.c_int
    lib.rf_commit_kind.argtypes = [c.c_void_p, c.c_int64]
    lib.rf_commit_size.restype = c.c_int64
    lib.rf_commit_size.argtypes = [c.c_void_p, c.c_int64]
    lib.rf_commit_copy.argtypes = [c.c_void_p, c.c_int64, P8]
    lib.rf_commit_clear.argtypes = [c.c_void_p]
    lib.rf_compact.argtypes = [c.c_void_p, c.c_uint64, P8, c.c_int64]
    lib.rf_transfer.restype = c.c_int
    lib.rf_transfer.argtypes = [c.c_void_p, c.c_int64]
    return lib


def get_lib():
    global _lib, _err
    with _lock:
        if _lib is not None or _err is not None:
            return _lib
        so, err = build_library(_SRC, "bkraft")
        if err is not None:
            _err = err
            return None
        try:
            _lib = _sig(ctypes.CDLL(so))
        except OSError as e:  # pragma: no cover
            _err = str(e)
            return None
        return _lib


def raft_available() -> bool:
    return get_lib() is not None


@dataclass
class Committed:
    index: int
    kind: int          # DATA / NOOP / CONFIG / SNAPSHOT_KIND
    data: bytes


class RaftCore:
    """One consensus participant (no IO — see cluster.LocalBus)."""

    def __init__(self, node_id: int, peers: list[int], seed: int = 1,
                 election_min: int = 10, election_max: int = 20,
                 hb_interval: int = 3):
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("native raft core unavailable")
        arr = (ctypes.c_int64 * len(peers))(*peers)
        self._h = self._lib.rf_new(node_id, arr, len(peers), seed,
                                   election_min, election_max, hb_interval)
        self.node_id = node_id

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.rf_free(h)
            self._h = None

    # -- drive ------------------------------------------------------------
    def tick(self):
        self._lib.rf_tick(self._h)

    def receive(self, msg: bytes):
        buf = (ctypes.c_uint8 * len(msg)).from_buffer_copy(msg)
        self._lib.rf_receive(self._h, buf, len(msg))

    def propose(self, data: bytes, kind: int = DATA) -> int:
        buf = (ctypes.c_uint8 * max(1, len(data))).from_buffer_copy(
            data or b"\0")
        return int(self._lib.rf_propose(self._h, kind, buf, len(data)))

    def transfer_leader(self, target: int) -> bool:
        return int(self._lib.rf_transfer(self._h, target)) == 0

    def compact(self, upto: int, snapshot: bytes):
        buf = (ctypes.c_uint8 * max(1, len(snapshot))).from_buffer_copy(
            snapshot or b"\0")
        self._lib.rf_compact(self._h, upto, buf, len(snapshot))

    # -- outputs ----------------------------------------------------------
    def drain_messages(self) -> list[tuple[int, bytes]]:
        lib, h = self._lib, self._h
        n = lib.rf_out_count(h)
        out = []
        for i in range(n):
            size = lib.rf_out_size(h, i)
            buf = (ctypes.c_uint8 * max(1, size))()
            lib.rf_out_copy(h, i, buf)
            out.append((int(lib.rf_out_dest(h, i)), ctypes.string_at(buf, size)))
        lib.rf_out_clear(h)
        return out

    def drain_commits(self) -> list[Committed]:
        lib, h = self._lib, self._h
        n = lib.rf_commit_count(h)
        out = []
        for i in range(n):
            size = lib.rf_commit_size(h, i)
            buf = (ctypes.c_uint8 * max(1, size))()
            lib.rf_commit_copy(h, i, buf)
            out.append(Committed(int(lib.rf_commit_index_at(h, i)),
                                 int(lib.rf_commit_kind(h, i)),
                                 ctypes.string_at(buf, size)))
        lib.rf_commit_clear(h)
        return out

    # -- state ------------------------------------------------------------
    @property
    def role(self) -> int:
        return int(self._lib.rf_role(self._h))

    @property
    def term(self) -> int:
        return int(self._lib.rf_term(self._h))

    @property
    def leader(self) -> int:
        return int(self._lib.rf_leader(self._h))

    @property
    def commit_index(self) -> int:
        return int(self._lib.rf_commit_index(self._h))

    @property
    def read_safe(self) -> bool:
        """Raft §8 read barrier: True once an entry of the CURRENT term is
        committed.  A fresh leader must not serve reads before this — it
        cannot yet have applied entries the old leader committed."""
        return bool(self._lib.rf_committed_current_term(self._h))

    @property
    def last_index(self) -> int:
        return int(self._lib.rf_last_index(self._h))

    @property
    def first_index(self) -> int:
        return int(self._lib.rf_first_index(self._h))

    def peers(self) -> list[int]:
        n = self._lib.rf_peer_count(self._h)
        arr = (ctypes.c_int64 * max(1, n))()
        self._lib.rf_peers(self._h, arr)
        return [int(arr[i]) for i in range(n)]

    def learners(self) -> list[int]:
        """Non-voting replicated members (reference: learner replicas,
        include/store/region.h:261-267)."""
        n = self._lib.rf_learner_count(self._h)
        arr = (ctypes.c_int64 * max(1, n))()
        self._lib.rf_learners(self._h, arr)
        return [int(arr[i]) for i in range(n)]
