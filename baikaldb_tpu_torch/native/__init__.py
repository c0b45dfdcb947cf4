"""The native host libraries: the row engine (``engine.cpp``) and the Raft
core (``raft.cpp``, bound in raft/core.py), their build and ctypes binding.

The port's copy of ``baikaldb_tpu/native/__init__.py``.  Both sources are
host C++, not device kernels: ``engine.cpp`` is the memcomparable key codec,
the MVCC memtable and its WAL; ``raft.cpp`` is a deterministic consensus
state machine.  Each is compiled with ``g++`` at first use into
``baikaldb_tpu_torch/_build/`` (git-ignored), under a name that carries a
hash of its source, to a temporary name that is then moved into place, so
concurrent first users (test workers) never load a half-written or stale
library (``build_library``).  ``get_lib()`` returns None when no compiler is
available and the callers take the pure-Python codec (storage/_pykeys.py);
``require()`` raises instead, for runs that must use the native engine.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "engine.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

_lock = threading.Lock()
_lib = None
_err: str | None = None


def _so_path(src: str = _SRC, stem: str = "bkengine") -> str:
    """One library per source content (the row engine's by default): an
    edited source never loads a stale build."""
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def build_library(src: str, stem: str) -> tuple[str, str | None]:
    """Compile ``src`` into ``_build/lib<stem>_<hash>.so`` unless it is
    there -> (library path, compiler error or None)."""
    so = _so_path(src, stem)
    return so, _build(src, so)


def _build(src: str, so: str) -> str | None:
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", src, "-o", tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except Exception as e:  # noqa: BLE001 — no compiler: the caller decides
        return f"{type(e).__name__}: {e}"
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        return r.stderr[-2000:]
    os.replace(tmp, so)
    return None


def _sig(lib):
    c = ctypes
    P8 = c.POINTER(c.c_uint8)
    P64 = c.POINTER(c.c_int64)
    lib.bk_batch_new.restype = c.c_void_p
    lib.bk_batch_new.argtypes = [c.c_int64]
    lib.bk_batch_free.argtypes = [c.c_void_p]
    lib.bk_batch_append_i64.argtypes = [c.c_void_p, P64, P8, c.c_int64]
    lib.bk_batch_append_f64.argtypes = [c.c_void_p, c.POINTER(c.c_double), P8, c.c_int64]
    lib.bk_batch_append_bytes.argtypes = [c.c_void_p, P8, P64, P8, c.c_int64]
    lib.bk_batch_total.restype = c.c_int64
    lib.bk_batch_total.argtypes = [c.c_void_p]
    lib.bk_batch_dump.argtypes = [c.c_void_p, P8, P64]
    lib.bk_table_new.restype = c.c_void_p
    lib.bk_table_free.argtypes = [c.c_void_p]
    lib.bk_table_open_wal.restype = c.c_int
    lib.bk_table_open_wal.argtypes = [c.c_void_p, c.c_char_p]
    lib.bk_table_wal_sync.argtypes = [c.c_void_p]
    lib.bk_table_write_batch.restype = c.c_uint64
    lib.bk_table_write_batch.argtypes = [c.c_void_p, P8, P8, P64, P8, P64, c.c_int64]
    lib.bk_table_snapshot.restype = c.c_uint64
    lib.bk_table_snapshot.argtypes = [c.c_void_p]
    lib.bk_table_get.restype = c.c_int64
    lib.bk_table_get.argtypes = [c.c_void_p, P8, c.c_int64, c.c_uint64, P8,
                                 c.c_int64, P64]
    lib.bk_table_scan.restype = c.c_void_p
    lib.bk_table_scan.argtypes = [c.c_void_p, P8, c.c_int64, P8, c.c_int64,
                                  c.c_uint64, c.c_int64]
    lib.bk_scan_count.restype = c.c_int64
    lib.bk_scan_count.argtypes = [c.c_void_p]
    lib.bk_scan_total_key_bytes.restype = c.c_int64
    lib.bk_scan_total_key_bytes.argtypes = [c.c_void_p]
    lib.bk_scan_total_val_bytes.restype = c.c_int64
    lib.bk_scan_total_val_bytes.argtypes = [c.c_void_p]
    lib.bk_scan_dump.argtypes = [c.c_void_p, P8, P64, P8, P64]
    lib.bk_scan_free.argtypes = [c.c_void_p]
    lib.bk_table_gc.argtypes = [c.c_void_p, c.c_uint64]
    lib.bk_table_num_keys.restype = c.c_int64
    lib.bk_table_num_keys.argtypes = [c.c_void_p]
    lib.bk_table_num_live_keys.restype = c.c_int64
    lib.bk_table_num_live_keys.argtypes = [c.c_void_p]
    return lib


def get_lib():
    """Load (building if needed) the native engine; None if unavailable."""
    global _lib, _err
    with _lock:
        if _lib is not None or _err is not None:
            return _lib
        so, err = build_library(_SRC, "bkengine")
        if err is not None:
            _err = err
            return None
        try:
            _lib = _sig(ctypes.CDLL(so))
        except OSError as e:
            _err = str(e)
            return None
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> str | None:
    get_lib()
    return _err


def require():
    """The native engine, or RuntimeError with the compiler's message."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"the native row engine did not build: {_err}")
    return lib
