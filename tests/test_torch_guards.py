"""The port's runtime guards (baikaldb_tpu_torch/analysis/runtime.py) held
against the JAX package's on the CPU.

- ``GuardedLock``: the same acquisition sequences through both packages
  give the same trips and the same messages (forward order, an inversion,
  re-entry after a higher rank, off mode silent).
- The lockset witness trips on an unguarded read of the port's
  ``BatchDispatcher`` and passes the read under its lock.
- The replicated write path (store lock -> binlog retry lock -> tier lock)
  runs under ``disallow`` on a port fleet.
- ``hot_path_guard`` on a CPU device never touches ``torch.cuda``; the
  sync half is exercised on the card (tests/test_torch_cuda.py).
- EXPLAIN ANALYZE's ``-- guards:`` line equals the JAX session's, text for
  text, under off, log and disallow, for phase-3-shaped SQL.
- Phase-3-shaped queries make no device->host read inside the guard scope
  but through ``host_read`` (checked on the CPU by intercepting the reads a
  CUDA tensor would make, with a torch function mode).
"""

import threading

import numpy as np
import pyarrow as pa
import pytest
import torch
from torch.overrides import TorchFunctionMode

from baikaldb_tpu.analysis import runtime as jrt
from baikaldb_tpu.utils.flags import set_flag as jset_flag
from baikaldb_tpu_torch.analysis import runtime as trt
from baikaldb_tpu_torch.utils.flags import set_flag as tset_flag

PACKAGES = {"jax": (jrt, jset_flag), "port": (trt, tset_flag)}


def _mode(mode: str) -> None:
    for _, set_flag in PACKAGES.values():
        set_flag("debug_guards", mode)


@pytest.fixture
def guards_off():
    yield
    _mode("off")


def _lock_script(rt, mode: str, tag: str) -> list:
    """One acquisition sequence -> [(step, lock-trip delta, error text)]."""
    G = rt.GuardedLock
    low = G(f"t.{tag}.low", rank=1, reentrant=True)
    high = G(f"t.{tag}.high", rank=2)
    out = []

    def step(name, fn):
        before = rt.guard_lock_trips.value
        err = None
        try:
            fn()
        except RuntimeError as e:
            err = str(e).replace(f"t.{tag}.", "t.")
        out.append((name, rt.guard_lock_trips.value - before, err))

    def forward():
        with low:
            with high:
                pass

    def inversion():
        with high:
            with low:
                pass

    def reentry():
        with low:
            with high:
                with low:
                    pass

    step("forward", forward)
    step("inversion", inversion)
    step("reentry", reentry)
    return out


@pytest.mark.parametrize("mode", ["off", "log", "disallow"])
def test_guarded_lock_sequences_match_jax(guards_off, capfd, mode):
    _mode(mode)
    runs = {}
    for pkg, (rt, _) in PACKAGES.items():
        runs[pkg] = _lock_script(rt, mode, f"{pkg}{mode}")
        runs[pkg + "_stderr"] = capfd.readouterr().err.replace(
            f"t.{pkg}{mode}.", "t.")
    assert runs["port"] == runs["jax"]
    assert runs["port_stderr"] == runs["jax_stderr"]
    trips = [d for _, d, _ in runs["port"]]
    assert trips == ([0, 0, 0] if mode == "off" else [0, 1, 0])
    errs = [e for _, _, e in runs["port"]]
    if mode == "disallow":
        assert errs[1].startswith("lock order violation: acquiring t.low (rank 1) "
                                  "while holding t.high (rank 2)")
    else:
        assert errs == [None, None, None]


def test_witness_trips_on_unguarded_dispatcher_read(guards_off):
    from baikaldb_tpu_torch.exec.dispatch import BatchDispatcher

    d = BatchDispatcher()
    before = trt.guard_owner_trips.value
    tset_flag("debug_guards", "disallow")
    with pytest.raises(RuntimeError, match="lockset witness: read of "
                       "baikaldb_tpu_torch/exec/dispatch.py:BatchDispatcher._groups"):
        d._groups            # noqa: B018 — the read IS the assertion
    assert trt.guard_owner_trips.value == before + 1
    with d._mu:
        assert isinstance(d._groups, dict)     # guarded: passes
    tset_flag("debug_guards", "off")
    assert isinstance(d._groups, dict)         # disarmed: a plain attribute
    assert trt.guard_owner_trips.value == before + 1


def test_replicated_write_path_under_disallow(guards_off):
    """store.table_lock -> db.binlog_retry_mu -> replicated.tier_mu: the
    armed guards accept the real write path's order on a port fleet."""
    from baikaldb_tpu_torch.raft.core import raft_available
    if not raft_available():
        pytest.skip("native raft core unavailable")
    from baikaldb_tpu_torch.exec.session import Database, Session
    from baikaldb_tpu_torch.meta.service import MetaService
    from baikaldb_tpu_torch.raft.fleet import StoreFleet

    fleet = StoreFleet(MetaService(peer_count=3), ["g1:1", "g2:1", "g3:1"], seed=7)
    s = Session(Database("cpu", fleet=fleet))
    lock0, owner0 = trt.guard_lock_trips.value, trt.guard_owner_trips.value
    tset_flag("debug_guards", "disallow")
    s.execute("CREATE DATABASE gd")
    s.execute("USE gd")
    s.execute("CREATE TABLE t (a BIGINT, b BIGINT)")
    s.execute("INSERT INTO t VALUES (1, 10), (2, 20)")
    s.execute("UPDATE t SET b = 25 WHERE a = 2")
    assert s.execute("SELECT SUM(b) FROM t").rows == [(35,)]
    assert (trt.guard_lock_trips.value, trt.guard_owner_trips.value) == (lock0, owner0)


def test_cpu_guard_never_touches_cuda(guards_off, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("torch.cuda touched for a CPU device")

    for name in ("set_sync_debug_mode", "get_sync_debug_mode", "is_available",
                 "synchronize", "current_device"):
        monkeypatch.setattr(torch.cuda, name, boom)
    for mode in ("off", "log", "disallow"):
        tset_flag("debug_guards", mode)
        with trt.hot_path_guard(torch.device("cpu")):
            x = torch.arange(10)
            assert int(x.sum()) == 45           # a CPU read is no transfer
            assert trt.host_read(x.sum()) == 45
            assert trt.host_read(x > 7, torch.nonzero).reshape(-1).tolist() == [8, 9]
        with trt.hot_path_guard("cpu"):
            pass
    assert trt.guard_stats()["mode"] == "disallow"


# ---- EXPLAIN ANALYZE -------------------------------------------------------

def _table(rows: int = 6000, seed: int = 0) -> pa.Table:
    rng = np.random.default_rng(seed)
    return pa.table({"g": rng.integers(0, 2048, rows, dtype=np.int32),
                     "v": rng.standard_normal(rows, dtype=np.float32),
                     "w": rng.standard_normal(rows),
                     "g16": rng.integers(0, 16, rows, dtype=np.int32)})


QUERIES = {
    "a": "SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t "
         "WHERE v*2+1 > 0.5 GROUP BY g16 ORDER BY g16",
    "b": "SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t "
         "WHERE v*2+1 > 0.5 GROUP BY g ORDER BY g",
    "c": "SELECT g, SUM(w), AVG(w) FROM t WHERE w > -1 GROUP BY g ORDER BY g",
}


@pytest.fixture(scope="module")
def pair():
    from baikaldb_tpu.exec.session import Session as JSession
    from baikaldb_tpu_torch.exec.session import Session as TSession

    t = _table()
    out = []
    for s in (JSession(), TSession(device="cpu")):
        s.execute("CREATE TABLE t (g INT, v FLOAT, w DOUBLE, g16 INT)")
        s.load_arrow("t", t)
        out.append(s)
    return out


def _equalize_counters() -> None:
    """Both packages' trip counters at the same values (other tests of the
    process may have moved either): the line is then comparable as text."""
    for name in ("guard_transfer_trips", "guard_lock_trips", "guard_owner_trips"):
        j, t = getattr(jrt, name), getattr(trt, name)
        lo, hi = sorted((j, t), key=lambda c: c.value)
        lo.add(hi.value - lo.value)


def _guards_line(s, q: str) -> str:
    lines = [ln for ln in s.execute("EXPLAIN ANALYZE " + q).plan_text.splitlines()
             if ln.startswith("-- guards:")]
    assert len(lines) == 1, lines
    return lines[0]


@pytest.mark.parametrize("mode", ["off", "log", "disallow"])
@pytest.mark.parametrize("q", sorted(QUERIES))
def test_explain_analyze_guards_line_matches_jax(pair, guards_off, mode, q):
    js, ts = pair
    _mode(mode)
    _equalize_counters()
    jl, tl = _guards_line(js, QUERIES[q]), _guards_line(ts, QUERIES[q])
    assert tl == jl
    assert tl.startswith(f"-- guards: mode={mode} transfer_trips=")


# ---- no implicit read inside the scope (CPU emulation of the card's guard) --

_T = torch.Tensor
_READS = {_T.item, _T.tolist, _T.cpu, _T.numpy, _T.__bool__, _T.__int__, _T.__float__,
          _T.__index__, torch.nonzero, _T.nonzero, torch.unique, _T.unique,
          torch.masked_select, _T.masked_select, torch.equal, torch.allclose}


class _ReadSpy(TorchFunctionMode):
    """Records the calls that read a CUDA tensor back, made by this thread
    inside an armed guard scope and outside ``host_read``."""

    def __init__(self):
        super().__init__()
        self.reads: list[str] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        bool_index = func in (_T.__getitem__, _T.__setitem__) and len(args) > 1 \
            and isinstance(args[1], torch.Tensor) and args[1].dtype == torch.bool
        if (func in _READS or bool_index) and trt.in_guarded_scope():
            self.reads.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_phase3_queries_read_only_through_host_read(pair, guards_off, q):
    _, ts = pair
    want = ts.query(QUERIES[q])
    tset_flag("debug_guards", "disallow")
    spy = _ReadSpy()
    with spy:
        got = ts.query(QUERIES[q])
    assert got == want
    assert spy.reads == []


def test_read_spy_sees_a_stray_read(guards_off):
    """The spy above is meaningful: a stray read inside the scope shows,
    the same read through host_read and a read on another thread do not."""
    tset_flag("debug_guards", "disallow")
    spy = _ReadSpy()
    other = []
    with spy:
        with trt.hot_path_guard(torch.device("cpu")):
            x = torch.arange(4)
            int(x.sum())
            trt.host_read(x.sum())
            th = threading.Thread(target=lambda: other.append(trt.in_guarded_scope()))
            th.start()
            th.join()
    assert spy.reads == ["__int__"] and other == [False]
