"""Segment reductions: the group-by primitive.

The port of ``baikaldb_tpu/ops/segments.py``.  ``seg_sum``/``seg_min``/
``seg_max`` are drop-in ``jax.ops.segment_*``: ids outside
``[0, num_segments)`` drop, and empty segments of ``seg_min``/``seg_max``
hold the dtype's max/min (+inf/-inf for floats).  As in the JAX package the
lowering forks by backend:

- **CUDA, 1-D x, num_segments <= onehot_max_segments** (2048 by default,
  measured on the H100 by ``bench/seg_gate.py``): the hand-written
  segment kernel of ``csrc/segments.cu`` (``segment_reduce``), the
  counterpart of the reference's fused select+reduce.  It keeps that
  branch's accumulation widths: int sums in the int dtype (wrapping), bool
  sums as int32, float sums in float64 returned in the input dtype.
- **CPU, multi-dimensional x, or more segments**: one ``index_add_`` /
  ``scatter_reduce_`` pass, sums accumulating in the input's dtype
  (callers cast integer sums to int64 and float sums to float64 first, as in
  the JAX package).

``segment_reduce`` launches the kernel on a CUDA tensor (counted in
``LAUNCHES``; a build or launch failure raises) and runs
``segment_reduce_plain`` on a CPU tensor: a literal
``where(gid[:, None] == arange(S), x, identity)`` reduced block by block of
rows, never building ``[n, S]`` at once, which is also what the kernel is
held against on the card.

Lanes (the batched dispatcher's tick, exec/lanes.py): ``seg_sum_lanes`` /
``seg_min_lanes`` / ``seg_max_lanes`` reduce a shared 1-D ``x`` by shared
ids ``gid`` once per row of a ``[G, n]`` ``mask`` (a row drops in lane
``g`` where ``mask[g]`` is false) -> ``[G, S]``, each lane equal to the
one-lane reduction over ``where(mask[g], gid, S)``.  On the kernel's route
that is ONE launch of ``segment_reduce_lanes``: a block carries a tile of
lanes (``lane_plan``: as many one-lane tables as fit in a block's shared
memory, at most ``LANE_TILE_MAX``), loads ``x`` and ``gid`` once for them
and runs the one-lane plan for each, so a lane's result is the one-lane
kernel's bit for bit; elsewhere the per-lane loop over the one-lane
function, which is also ``segment_reduce_lanes_plain``.  The lane launches
count in ``LANE_LAUNCHES``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils import metrics
from ..utils.flags import FLAGS
from . import group_kernels as gk

SOURCE = gk.SOURCES["segments"]
MAX_SEGMENTS = 16384              # csrc/segments.cu: MAX_SEGMENTS
MODES = {"auto": 0, "private": 1, "warp": 2, "block": 3}   # table layouts
_OPS = {"sum": 0, "min": 1, "max": 2}
_TCODE = {torch.bool: 0, torch.int32: 1, torch.int64: 2, torch.float32: 3,
          torch.float64: 4}
_PLAIN_ELEMS = 1 << 24            # [rows, S] elements per block of the plain version

# the kernel's table plan (csrc/segments.cu: THREADS, WARPS, PRIVATE_BYTES,
# WARP_BYTES, SMEM_MAX, LANE_TILE_MAX, LANE_SMEM_MAX), and the bytes of its
# accumulators per (op, dtype) (Red<OP, T>::Acc: float sums in float64,
# float MIN/MAX as integer keys of the float's width, bool as int32)
_THREADS, _WARPS = 256, 8
_PRIVATE_BYTES, _WARP_BYTES, _SMEM_MAX = 48 * 1024, 64 * 1024, 8 * MAX_SEGMENTS
LANE_TILE_MAX = 6                 # lanes one block of the lane kernel carries
LANE_SMEM_MAX = gk.LANE_SMEM_MAX  # 227 KB: one block's shared memory on sm_90
_ACC_BYTES = {torch.bool: 4, torch.int32: 4, torch.int64: 8, torch.float32: 4,
              torch.float64: 8}

LAUNCHES = {"segment_reduce": metrics.Counter("kernel_launches.segment_reduce")}
LANE_LAUNCHES = {"segment_reduce_lanes": metrics.Counter("kernel_launches.segment_reduce_lanes")}


# the JAX package's ONEHOT_MAX_SEGMENTS: the gate of the CPU routes, which
# the tier-1 parity tests hold against the reference's
CPU_MAX_SEGMENTS = 512


def max_segments(device) -> int:
    """The crossover on ``device``: at most this many segments take the
    segment kernel, and the dense group-by kernels engage above it.  On
    CUDA the flag (utils/flags.py: onehot_max_segments); on the CPU the JAX
    package's 512, so the CPU takes the reference's routes."""
    if torch.device(device).type == "cuda":
        return int(FLAGS.onehot_max_segments)
    return CPU_MAX_SEGMENTS


def _kernel_route(x: torch.Tensor, gid: torch.Tensor, num_segments: int) -> bool:
    return (x.device.type == "cuda" and x.ndim == 1 and x.dtype in _TCODE
            and gid.dtype in (torch.int32, torch.int64)
            and 1 <= num_segments <= min(max_segments(x.device), MAX_SEGMENTS))


def _routed(gid: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Ids with out-of-range rows sent to the extra drop slot."""
    ok = (gid >= 0) & (gid < num_segments)
    return torch.where(ok, gid, num_segments).to(torch.int64)


def seg_sum(x: torch.Tensor, gid: torch.Tensor, num_segments: int) -> torch.Tensor:
    if _kernel_route(x, gid, num_segments):
        return segment_reduce(x.contiguous(), gid.contiguous(), num_segments, "sum")
    if x.dtype is torch.bool:
        x = x.to(torch.int32)
    out = torch.zeros((num_segments + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out.index_add_(0, _routed(gid, num_segments), x)
    return out[:num_segments]


def _identity(dtype: torch.dtype, is_min: bool):
    if dtype.is_floating_point:
        return float("inf") if is_min else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if is_min else info.min


def _seg_extremum(x: torch.Tensor, gid: torch.Tensor, num_segments: int,
                  is_min: bool) -> torch.Tensor:
    if _kernel_route(x, gid, num_segments):
        return segment_reduce(x.contiguous(), gid.contiguous(), num_segments,
                              "min" if is_min else "max")
    if x.dtype is torch.bool:
        x = x.to(torch.int32)
    out = torch.full((num_segments + 1,), _identity(x.dtype, is_min), dtype=x.dtype,
                     device=x.device)
    out.scatter_reduce_(0, _routed(gid, num_segments), x,
                        reduce="amin" if is_min else "amax", include_self=True)
    return out[:num_segments]


def seg_min(x, gid, num_segments: int):
    """Drop-in ``jax.ops.segment_min`` (empty segments get dtype max/+inf)."""
    return _seg_extremum(x, gid, num_segments, True)


def seg_max(x, gid, num_segments: int):
    """Drop-in ``jax.ops.segment_max`` (empty segments get dtype min/-inf)."""
    return _seg_extremum(x, gid, num_segments, False)


def _lanes_route(x, gid, mask, num_segments: int) -> bool:
    return (_kernel_route(x, gid, num_segments) and mask.device == x.device
            and 1 <= mask.shape[0] <= 65535)


def _per_lane(f, x, gid, mask, num_segments: int) -> torch.Tensor:
    """``f`` (a one-lane segment function) once per mask row."""
    drop = torch.full((), num_segments, dtype=gid.dtype, device=gid.device)
    return torch.stack([f(x, torch.where(m, gid, drop), num_segments) for m in mask])


def seg_sum_lanes(x, gid, mask, num_segments: int) -> torch.Tensor:
    """``seg_sum`` of a shared ``x`` once per lane of ``mask`` -> [G, S]."""
    if _lanes_route(x, gid, mask, num_segments):
        return segment_reduce_lanes(x.contiguous(), gid.contiguous(), mask.contiguous(),
                                    num_segments, "sum")
    return _per_lane(seg_sum, x, gid, mask, num_segments)


def seg_min_lanes(x, gid, mask, num_segments: int) -> torch.Tensor:
    if _lanes_route(x, gid, mask, num_segments):
        return segment_reduce_lanes(x.contiguous(), gid.contiguous(), mask.contiguous(),
                                    num_segments, "min")
    return _per_lane(seg_min, x, gid, mask, num_segments)


def seg_max_lanes(x, gid, mask, num_segments: int) -> torch.Tensor:
    if _lanes_route(x, gid, mask, num_segments):
        return segment_reduce_lanes(x.contiguous(), gid.contiguous(), mask.contiguous(),
                                    num_segments, "max")
    return _per_lane(seg_max, x, gid, mask, num_segments)


# ----------------------------------------------------------------------
# the segment kernel and its plain version


def _widths(op: str, dtype: torch.dtype) -> tuple[torch.dtype, torch.dtype]:
    """(accumulator, output) dtypes of the reference's select+reduce."""
    if op == "sum":
        if dtype is torch.bool:
            return torch.int64, torch.int32
        return (torch.float64 if dtype.is_floating_point else dtype), dtype
    dt = torch.int32 if dtype is torch.bool else dtype
    return dt, dt


def segment_reduce_plain(x: torch.Tensor, gid: torch.Tensor, num_segments: int,
                         op: str) -> torch.Tensor:
    """``where(gid[:, None] == arange(S), x, identity)`` reduced over the
    rows, a block of rows at a time; a NaN in a segment makes its MIN/MAX
    NaN (``amin``/``amax`` and ``minimum``/``maximum`` propagate it)."""
    acc, out_dt = _widths(op, x.dtype)
    dev = x.device
    ident = torch.tensor(0 if op == "sum" else _identity(acc, op == "min"), dtype=acc,
                         device=dev)
    k = torch.arange(num_segments, dtype=gid.dtype, device=dev)
    out = ident.expand(num_segments).clone()
    rows = max(1, _PLAIN_ELEMS // max(num_segments, 1))
    for a in range(0, x.shape[0], rows):
        masked = torch.where(gid[a:a + rows, None] == k, x[a:a + rows, None].to(acc), ident)
        if op == "sum":
            out = out + masked.sum(0, dtype=acc)
        elif op == "min":
            out = torch.minimum(out, masked.amin(0))
        else:
            out = torch.maximum(out, masked.amax(0))
    return out.to(out_dt)


def segment_reduce(x: torch.Tensor, gid: torch.Tensor, num_segments: int, op: str,
                   mode: str = "auto") -> torch.Tensor:
    """SUM/MIN/MAX of a 1-D ``x`` per segment of ``gid`` (int32/int64) ->
    [num_segments] in the reference's output dtype.  On a CUDA tensor the
    kernel of ``csrc/segments.cu`` with the table layout ``mode`` (the
    gate sweep of ``bench/seg_gate.py`` forces one; ``auto`` picks by
    segment count); on a CPU tensor the plain version."""
    _check(x, gid, num_segments, op, mode)
    if x.device.type == "cpu":
        return segment_reduce_plain(x, gid, num_segments, op)
    return _launch(x, gid, num_segments, op, MODES[mode])


def segment_reduce_lanes_plain(x, gid, mask, num_segments: int, op: str) -> torch.Tensor:
    """The per-lane loop over ``segment_reduce_plain``."""
    return _per_lane(lambda xx, gg, s: segment_reduce_plain(xx, gg, s, op), x, gid, mask,
                     num_segments)


def segment_reduce_lanes(x: torch.Tensor, gid: torch.Tensor, mask: torch.Tensor,
                         num_segments: int, op: str, mode: str = "auto") -> torch.Tensor:
    """SUM/MIN/MAX of a shared 1-D ``x`` per segment of the shared ``gid``,
    once per row of the bool ``mask`` [G, n] -> [G, num_segments].  On a
    CUDA tensor ONE launch of the lane kernel, in the tiles of ``lane_plan``;
    on a CPU tensor the plain version."""
    _check(x, gid, num_segments, op, mode)
    if mask.dtype is not torch.bool or mask.ndim != 2 or mask.shape[1:] != x.shape \
            or not 1 <= mask.shape[0] <= 65535:
        raise TypeError(f"mask must be bool[G, N] with 1 <= G <= 65535 beside x "
                        f"{tuple(x.shape)}, got {mask.dtype}{tuple(mask.shape)}")
    if mask.device != x.device or not mask.is_contiguous():
        raise ValueError("mask must be contiguous and lie on x's device")
    if x.device.type == "cpu":
        return segment_reduce_lanes_plain(x, gid, mask, num_segments, op)
    return _launch(x, gid, num_segments, op, MODES[mode], mask,
                   lane_plan(op, x.dtype, num_segments, mask.shape[0], mode).tile)


class LanePlan(NamedTuple):
    layout: str          # "private", "warp" or "block": the one-lane table layout
    table_bytes: int     # one lane's table in shared memory
    fit: int             # lanes whose tables fit a block
    tile: int            # lanes a block carries
    tiles: int           # blocks a row-block of the one-lane grid becomes


def table_layout(op: str, dtype: torch.dtype, num_segments: int,
                 mode: str = "auto") -> tuple[str, int]:
    """(layout, bytes) of the kernel's table of ``num_segments`` slots:
    private copies a thread while they fit 48 KB, else copies a warp within
    64 KB, else one a block (csrc/segments.cu table_layout)."""
    acc = 8 if op == "sum" and dtype.is_floating_point else _ACC_BYTES[dtype]
    slot = acc * int(num_segments)
    if mode == "auto":
        mode = ("private" if slot * _THREADS <= _PRIVATE_BYTES
                else "warp" if slot * 2 <= _WARP_BYTES else "block")
    replicas = {"private": _THREADS, "warp": max(1, min(_WARPS, _WARP_BYTES // slot)),
                "block": 1}[mode]
    if slot * replicas > _SMEM_MAX:
        raise ValueError(f"a {mode} table of {num_segments} {dtype} {op} slots takes "
                         f"{slot * replicas} bytes, over {_SMEM_MAX}")
    return mode, slot * replicas


def lane_plan(op: str, dtype: torch.dtype, num_segments: int, lanes: int,
              mode: str = "auto") -> LanePlan:
    """The lane kernel's tiles for ``lanes`` lanes: as many one-lane tables
    as fit ``LANE_SMEM_MAX`` (at most ``LANE_TILE_MAX``), then the lanes
    spread evenly over the fewest tiles (the last tile may be shorter)."""
    layout, nbytes = table_layout(op, dtype, num_segments, mode)
    fit = min(LANE_TILE_MAX, LANE_SMEM_MAX // nbytes)
    return LanePlan(layout, nbytes, fit, *gk.lane_tiles(lanes, fit))


def _check(x, gid, num_segments: int, op: str, mode: str) -> None:
    """Raise on what the kernel does not take."""
    if op not in _OPS or mode not in MODES:
        raise ValueError(f"unknown op {op!r} or mode {mode!r}")
    if not 1 <= int(num_segments) <= MAX_SEGMENTS:
        raise ValueError(f"num_segments {num_segments} outside [1, {MAX_SEGMENTS}]")
    if x.ndim != 1 or x.dtype not in _TCODE:
        raise TypeError(f"x must be 1-D bool/int32/int64/float32/float64, got "
                        f"{x.dtype}{tuple(x.shape)}")
    if gid.dtype not in (torch.int32, torch.int64) or gid.shape != x.shape:
        raise TypeError(f"gid must be int32/int64{tuple(x.shape)}, got "
                        f"{gid.dtype}{tuple(gid.shape)}")
    if gid.device != x.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x and gid must lie on one CPU or CUDA device, got "
                         f"{x.device} and {gid.device}")
    if not (x.is_contiguous() and gid.is_contiguous()):
        raise ValueError("x and gid must be contiguous")


def _bind(lib) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bk_seg_blocks.argtypes = [i32, i32, i32, i32, i64, i32, i32]
    lib.bk_seg_blocks.restype = i32
    lib.bk_seg_ws_bytes.argtypes = [i32, i32, i32, i32]
    lib.bk_seg_ws_bytes.restype = i64
    lib.bk_seg_max_segments.restype = i32
    lib.bk_seg_reduce.argtypes = [i32, i32, i32, i32, vp, vp, i64, i32, i32, i32, vp, vp, vp]
    lib.bk_seg_reduce.restype = i32
    lib.bk_seg_reduce_lanes.argtypes = [i32, i32, i32, i32, vp, vp, vp, i32, i32, i64, i32,
                                        i32, i32, vp, vp, vp]
    lib.bk_seg_reduce_lanes.restype = i32
    lib.bk_seg_table_bytes.argtypes = [i32, i32, i32, i32]
    lib.bk_seg_table_bytes.restype = i64
    lib.bk_seg_lane_tile_max.restype = i32
    lib.bk_seg_lane_smem_max.restype = i64
    if (lib.bk_seg_max_segments(), lib.bk_seg_lane_tile_max(), lib.bk_seg_lane_smem_max()) \
            != (MAX_SEGMENTS, LANE_TILE_MAX, LANE_SMEM_MAX):
        raise RuntimeError("csrc/segments.cu and ops/segments.py disagree on MAX_SEGMENTS, "
                           "LANE_TILE_MAX or LANE_SMEM_MAX")


def _launch(x, gid, S: int, op: str, mode: int, mask=None, tile: int = 1) -> torch.Tensor:
    """The kernel over one lane (``mask`` None) or the rows of ``mask``,
    ``tile`` lanes a block."""
    lib = gk.library(SOURCE, _bind)
    dev = x.device
    device = gk._device_index(dev)
    opc, tcode, id64 = _OPS[op], _TCODE[x.dtype], int(gid.dtype is torch.int64)
    n = x.shape[0]
    G = 1 if mask is None else mask.shape[0]
    blocks = lib.bk_seg_blocks(device, opc, tcode, id64, n, S, mode)
    if blocks <= 0:
        raise RuntimeError(f"segment_reduce: launch plan failed with error {-blocks}")
    # the workspace goes back to the caching allocator on return; it hands
    # the block out again only in this stream's order, after these kernels
    ws = torch.empty(-(-G * lib.bk_seg_ws_bytes(opc, tcode, blocks, S) // 8),
                     dtype=torch.int64, device=dev)
    out = torch.empty((S,) if mask is None else (G, S), dtype=_widths(op, x.dtype)[1],
                      device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if mask is None:
        err = lib.bk_seg_reduce(device, opc, tcode, id64, x.data_ptr(), gid.data_ptr(), n, S,
                                mode, blocks, ws.data_ptr(), out.data_ptr(), stream)
        name = "segment_reduce"
    else:
        err = lib.bk_seg_reduce_lanes(device, opc, tcode, id64, x.data_ptr(), gid.data_ptr(),
                                      mask.data_ptr(), G, tile, n, S, mode, blocks,
                                      ws.data_ptr(), out.data_ptr(), stream)
        name = "segment_reduce_lanes"
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error {err}")
    (LAUNCHES if mask is None else LANE_LAUNCHES)[name].add(1)
    return out
