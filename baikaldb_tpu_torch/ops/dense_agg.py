"""The wide dense GROUP BY kernel (``csrc/dense_agg.cu``): its accumulator
plan and its launch.

A dense GROUP BY above the segment kernel's gate that K1-K3 decline
(``ops/hashagg.py`` ``dense_route`` "wide") runs every aggregate in one
pass over the rows.  ``wide_plan`` turns the aggregates into accumulators,
one per (kind, column): a SUM or AVG into an int64 or float64 sum
(``_sum_dtype``'s widths), MIN and MAX in the column's dtype, and for a
column with NULLs its int32 count where COUNT or AVG needs it, else a
one-byte non-empty flag.  The live count per slot, which gives ``present``,
COUNT(*) and the counts of a column without NULLs, is always taken.

``launch`` fills the outputs on the device (``torch.zeros`` / ``torch.full``
with each accumulator's identity), launches the kernel once on the current
stream and counts it in ``LAUNCHES``; a build or launch failure raises.  It
takes CUDA tensors only: the plain version beside the wrapper
(``ops/hashagg.py`` ``dense_group_agg_plain``) runs everywhere else.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils import metrics
from . import group_kernels as gk
from .segments import _identity

SOURCE = gk.SOURCES["dense_agg"]
MAX_ACCS = 32                     # csrc/dense_agg.cu: MAX_ACCS
COUNT, FLAG, SUM_I64, SUM_F64, MIN, MAX = range(6)
VTYPES = {torch.int32: 1, torch.int64: 2, torch.float32: 3, torch.float64: 4}

LAUNCHES = {"dense_group_agg": metrics.Counter("kernel_launches.dense_group_agg")}


# the slots' dtype of each kind; MIN and MAX keep the column's
DTYPES = {COUNT: torch.int32, FLAG: torch.uint8, SUM_I64: torch.int64, SUM_F64: torch.float64}


class Acc(NamedTuple):
    kind: int                     # COUNT, FLAG, SUM_I64, SUM_F64, MIN or MAX
    input: str                    # the column it reads


def wide_plan(specs, cols: dict) -> list[Acc]:
    """The accumulators of ``specs`` over ``cols`` (input name -> Column),
    each once, in the order the specs first need them."""
    counted = {s.input for s in specs if s.op in ("count", "avg")}
    accs: list[Acc] = []

    def add(a: Acc) -> None:
        if a not in accs:
            accs.append(a)

    for s in specs:
        if s.op == "count_star":
            continue
        c = cols[s.input]
        if c.validity is not None:
            add(Acc(COUNT if s.input in counted else FLAG, s.input))
        if s.op in ("sum", "avg"):
            add(Acc(SUM_I64 if s.op == "sum" and c.ltype.is_integer else SUM_F64, s.input))
        elif s.op in ("min", "max"):
            add(Acc(MIN if s.op == "min" else MAX, s.input))
    return accs


def _fill(a: Acc, dtype: torch.dtype, ng: int, dev) -> torch.Tensor:
    if a.kind in (MIN, MAX):
        return torch.full((ng,), _identity(dtype, a.kind == MIN), dtype=dtype, device=dev)
    return torch.zeros(ng, dtype=dtype, device=dev)


def _check(gid, sel, vals: list, valids: list, ng: int) -> None:
    """Raise on what the kernel does not take."""
    if gid.device.type != "cuda" or gid.dtype is not torch.int32 or gid.ndim != 1:
        raise TypeError(f"gid must be a CUDA int32[N], got {gid.dtype}{tuple(gid.shape)} "
                        f"on {gid.device}")
    if not 1 <= ng < 2 ** 31 or len(vals) > MAX_ACCS:
        raise ValueError(f"{ng} slots or {len(vals)} accumulators outside [1, 2**31) / "
                         f"[0, {MAX_ACCS}]")
    for m in [sel, *valids]:
        if m is not None and (m.dtype is not torch.bool or m.shape != gid.shape
                              or m.device != gid.device):
            raise TypeError("sel and every validity must be bool[N] beside gid")
    for v in vals:
        if v.dtype not in VTYPES or v.shape != gid.shape or v.device != gid.device:
            raise TypeError(f"a column must be int32/int64/float32/float64[N] beside gid, "
                            f"got {v.dtype}{tuple(v.shape)} on {v.device}")


def _bind(lib) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ip, pp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)
    lib.bk_dense_agg.argtypes = [i32, vp, vp, i64, i32, vp, i32, ip, ip, pp, pp, pp, vp]
    lib.bk_dense_agg.restype = i32
    lib.bk_dense_agg_max_accs.restype = i32
    if lib.bk_dense_agg_max_accs() != MAX_ACCS:
        raise RuntimeError("csrc/dense_agg.cu and ops/dense_agg.py disagree on MAX_ACCS")


def launch(gid, sel, cols: dict, accs: list[Acc], ng: int):
    """The kernel over ``gid`` (int32 [N]) and ``sel`` (bool [N] or None)
    -> (live counts int32 [ng], one tensor [ng] per accumulator)."""
    vals = [cols[a.input].data for a in accs]
    valids = [cols[a.input].validity for a in accs]
    _check(gid, sel, vals, valids, ng)
    # the copies of a strided column go back to the caching allocator on
    # return, which hands them out again only in this stream's order
    gid, vals = gid.contiguous(), [v.contiguous() for v in vals]
    sel = None if sel is None else sel.contiguous()
    valids = [None if m is None else m.contiguous() for m in valids]
    lib = gk.library(SOURCE, _bind)
    dev = gid.device
    cnt = torch.zeros(ng, dtype=torch.int32, device=dev)
    outs = [_fill(a, DTYPES.get(a.kind, v.dtype), ng, dev) for a, v in zip(accs, vals)]
    k = len(accs)
    err = lib.bk_dense_agg(
        gk._device_index(dev), gid.data_ptr(), None if sel is None else sel.data_ptr(),
        gid.shape[0], ng, cnt.data_ptr(), k,
        (ctypes.c_int * k)(*(a.kind for a in accs)),
        (ctypes.c_int * k)(*(VTYPES[v.dtype] for v in vals)),
        (ctypes.c_void_p * k)(*(o.data_ptr() for o in outs)),
        (ctypes.c_void_p * k)(*(v.data_ptr() for v in vals)),
        (ctypes.c_void_p * k)(*(None if m is None else m.data_ptr() for m in valids)),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dense_group_agg: CUDA kernel launch failed with error {err}")
    LAUNCHES["dense_group_agg"].add(1)
    return cnt, outs
