"""Hand-written CUDA kernels for mid-cardinality dense GROUP BY, and their
plain torch versions.

The port of ``baikaldb_tpu/ops/pallas_kernels.py``.  Three entry points keep
the Pallas kernels' contract (codes int32[N], values [N] contracted as
float32, mask bool[N]; rows with a false mask or a code outside
``[0, num_groups)`` drop), except that counts are int64[num_groups], exact
at any row count (the Pallas kernels' float32 counts round above 2^24);
sums, mins and maxs are float32[num_groups]:

- ``filtered_group_sum``    (K1) -> (counts, sums)
- ``fused_group_aggregate`` (K2) -> (counts, sums, mins, maxs); an empty
  group's min/max hold +3.4e38 / -3.4e38 and its count of 0 marks it; a
  group holding a NaN (either sign) gives NaN for its sum, min and max
- ``partition_histogram``   (K3) -> counts

On a CUDA tensor each entry point launches its kernel from
``csrc/group_agg.cu`` (built with ``nvcc`` for ``sm_90a`` into
``baikaldb_tpu_torch/_build/`` at first use, bound with ctypes) and counts
the launch in ``LAUNCHES``; a build or launch failure raises.  A call's
outputs are views of one buffer that also held its workspace.  On a CPU
tensor it runs the ``*_plain`` version beside it (``index_add_`` /
``scatter_reduce_``, the same drop rules and sentinels), which is also what
the kernels are held against on the card.

Each has a lane-batched entry beside it (``*_lanes``), for the batched
dispatcher's tick (exec/lanes.py): ``codes`` and ``values`` are ``[N]``,
shared by the lanes, ``mask`` is ``[G, N]`` (one row a lane) and every
output is ``[G, num_groups]``; lane ``g``'s result equals the one-lane call
on ``mask[g]`` (its sums up to the order of the float64 additions).  On a
CUDA tensor it is ONE launch over all lanes
(``LANE_LAUNCHES[f"{name}_lanes"]``): each kernel carries a tile of lanes a
block (``lane_plan``: as many lanes' tables as fit a block's shared memory,
at most ``LANE_TILE_MAX``, for K2 ``AGG_LANE_MAX``) and loads codes and
values once for the tile.  On a CPU tensor its plain version, the per-lane
loop over the one-lane plain function.

The build machinery here (``build``, ``build_all``, ``library``) serves
every CUDA source of the port (``SOURCES``): one ``nvcc`` per source, the
library cached by the source's content.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import NamedTuple

import torch

from ..utils import metrics

MAX_GROUPS = 4096
_BIG = 3.4e38                     # empty-group min/max sentinel (float32)
KIND_HIST, KIND_SUM, KIND_AGG = 0, 1, 2     # K3, K1, K2 in lane_plan
LANE_TILE_MAX = 16                # lanes one block of K1/K3's lane kernel carries
LANE_SMEM_MAX = 232448            # 227 KB: one block's shared memory on sm_90
AGG_LANE_MAX = 4                  # lanes one block of K2's lane kernel carries

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = {name: os.path.join(_HERE, "csrc", f"{name}.cu")
           for name in ("group_agg", "segments")}
SOURCE = SOURCES["group_agg"]
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# nvcc options of one source beyond the common ones: segments.cu's many
# template instances make it the build's long pole, and --split-compile
# spreads its optimization over the cores (chip_smoke.py prints the build's
# seconds); group_agg.cu does not build with it under nvcc 12.9 ("Failed to
# read bitcode")
_SOURCE_FLAGS = {SOURCES["segments"]: ("--split-compile=0",)}

# one launch counter per kernel: added to only where the kernel launches
LAUNCHES = {name: metrics.Counter(f"kernel_launches.{name}")
            for name in ("filtered_group_sum", "fused_group_aggregate",
                         "partition_histogram")}
# the lane-batched entries count apart: one a launch over all lanes
LANE_LAUNCHES = {f"{name}_lanes": metrics.Counter(f"kernel_launches.{name}_lanes")
                 for name in LAUNCHES}

_lock = threading.Lock()
_libs: dict = {}           # source path -> bound ctypes library


# ----------------------------------------------------------------------
# plain torch versions


def _routed(codes, mask, num_groups: int) -> torch.Tensor:
    live = mask & (codes >= 0) & (codes < num_groups)
    return torch.where(live, codes, num_groups).to(torch.int64)


def _counts(gid, num_groups: int, rows=None) -> torch.Tensor:
    """Rows per group (int64); only the rows where ``rows`` is true, if given."""
    c = torch.zeros(num_groups + 1, dtype=torch.int64, device=gid.device)
    c.index_add_(0, gid, torch.ones_like(gid) if rows is None else rows.to(torch.int64))
    return c[:num_groups]


def _sums(gid, values, num_groups: int) -> torch.Tensor:
    s = torch.zeros(num_groups + 1, dtype=torch.float64, device=gid.device)
    s.index_add_(0, gid, values.to(torch.float32).to(torch.float64))
    return s[:num_groups].to(torch.float32)


def _extremum(gid, values, num_groups: int, is_min: bool, has_nan) -> torch.Tensor:
    out = torch.full((num_groups + 1,), _BIG if is_min else -_BIG,
                     dtype=torch.float32, device=gid.device)
    out.scatter_reduce_(0, gid, values, reduce="amin" if is_min else "amax",
                        include_self=True)
    # NaN wins, whatever scatter_reduce_ does with it on this device
    return torch.where(has_nan, float("nan"), out[:num_groups])


def filtered_group_sum_plain(codes, values, mask, num_groups: int):
    gid = _routed(codes, mask, num_groups)
    return _counts(gid, num_groups), _sums(gid, values, num_groups)


def fused_group_aggregate_plain(codes, values, mask, num_groups: int):
    gid = _routed(codes, mask, num_groups)
    v = values.to(torch.float32)
    has_nan = _counts(gid, num_groups, torch.isnan(v)) > 0
    return (_counts(gid, num_groups), _sums(gid, values, num_groups),
            _extremum(gid, v, num_groups, True, has_nan),
            _extremum(gid, v, num_groups, False, has_nan))


def partition_histogram_plain(dest, mask, num_partitions: int):
    return _counts(_routed(dest, mask, num_partitions), num_partitions)


# ----------------------------------------------------------------------
# entry points


def filtered_group_sum(codes, values, mask, num_groups: int):
    """Fused filter + dense group-by COUNT/SUM -> (counts int64, sums
    float32)."""
    _check(codes, mask, num_groups, values)
    if codes.device.type == "cpu":
        return filtered_group_sum_plain(codes, values, mask, num_groups)
    return _launch("filtered_group_sum", KIND_SUM, codes, values, mask, num_groups)


def fused_group_aggregate(codes, values, mask, num_groups: int):
    """Fused filter + dense group-by COUNT/SUM/MIN/MAX in one pass ->
    (counts int64, sums, mins, maxs float32)."""
    _check(codes, mask, num_groups, values)
    if codes.device.type == "cpu":
        return fused_group_aggregate_plain(codes, values, mask, num_groups)
    return _launch_agg(codes, values, mask, num_groups)


def partition_histogram(dest, mask, num_partitions: int):
    """Row count per destination code under a mask -> counts int64."""
    _check(dest, mask, num_partitions)
    if dest.device.type == "cpu":
        return partition_histogram_plain(dest, mask, num_partitions)
    return _launch("partition_histogram", KIND_HIST, dest, None, mask,
                   num_partitions)[0]


def _check(codes, mask, num_groups: int, values=None) -> None:
    """Raise on what the kernels do not take."""
    if not 1 <= int(num_groups) <= MAX_GROUPS:
        raise ValueError(f"num_groups {num_groups} outside [1, {MAX_GROUPS}]")
    if codes.dtype is not torch.int32 or codes.ndim != 1:
        raise TypeError(f"codes must be int32[N], got {codes.dtype}{tuple(codes.shape)}")
    if mask.dtype is not torch.bool or mask.shape != codes.shape:
        raise TypeError(f"mask must be bool{tuple(codes.shape)}, got "
                        f"{mask.dtype}{tuple(mask.shape)}")
    tensors = [codes, mask]
    if values is not None:
        if values.dtype not in (torch.float32, torch.float64) or values.shape != codes.shape:
            raise TypeError(f"values must be float32/float64{tuple(codes.shape)}, got "
                            f"{values.dtype}{tuple(values.shape)}")
        tensors.append(values)
    if any(t.device != codes.device for t in tensors):
        raise ValueError("codes, mask and values must lie on one device")
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {codes.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("codes, mask and values must be contiguous")


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _launch(name, kind, codes, values, mask, ng: int):
    """K1/K3: one int64 [1 or 3, ng] buffer; row 0 holds the uint64 workspace
    counts, which are the int64 count output; for K1, row 1 the float64
    workspace sums and row 2 the float32 sums."""
    lib = _library()
    dev = codes.device
    buf = torch.empty((1 if kind == KIND_HIST else 3, ng), dtype=torch.int64, device=dev)
    base = buf.data_ptr()
    err = lib.bk_group_agg(
        _device_index(dev), kind, int(values is not None and values.dtype is torch.float64),
        codes.data_ptr(), None if values is None else values.data_ptr(), mask.data_ptr(),
        codes.shape[0], ng, base, None if kind == KIND_HIST else base + 8 * ng,
        None if kind == KIND_HIST else base + 16 * ng,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error {err}")
    LAUNCHES[name].add(1)
    if kind == KIND_HIST:
        return (buf[0],)
    return buf[0], buf[2].view(torch.float32)[:ng]


def _launch_agg(codes, values, mask, ng: int):
    """K2: one int64 buffer: the int64 counts, then the float32 sums, mins
    and maxs (3 * ng floats, rounded up to whole words), then the per-block
    workspace."""
    lib = _library()
    dev = codes.device
    device = _device_index(dev)
    f64 = int(values.dtype is torch.float64)
    n = codes.shape[0]
    blocks = lib.bk_fused_agg_blocks(device, f64, n, ng)
    if blocks <= 0:
        raise RuntimeError(f"fused_group_aggregate: launch geometry failed with error {-blocks}")
    fwords = -(-3 * ng // 2)
    ws_words = -(-lib.bk_fused_agg_ws_bytes(blocks, ng) // 8)
    buf = torch.empty(ng + fwords + ws_words, dtype=torch.int64, device=dev)
    base = buf.data_ptr()
    err = lib.bk_fused_agg(device, f64, codes.data_ptr(), values.data_ptr(), mask.data_ptr(),
                           n, ng, blocks, base + 8 * (ng + fwords), base, base + 8 * ng,
                           torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_group_aggregate: CUDA kernel launch failed with error {err}")
    LAUNCHES["fused_group_aggregate"].add(1)
    f = buf[ng:ng + fwords].view(torch.float32)
    return buf[:ng], f[:ng], f[ng:2 * ng], f[2 * ng:3 * ng]


# ----------------------------------------------------------------------
# lane-batched entry points (one launch a tick) and their plain versions


def filtered_group_sum_lanes_plain(codes, values, mask, num_groups: int):
    outs = [filtered_group_sum_plain(codes, values, m, num_groups) for m in mask]
    return tuple(torch.stack(o) for o in zip(*outs))


def fused_group_aggregate_lanes_plain(codes, values, mask, num_groups: int):
    outs = [fused_group_aggregate_plain(codes, values, m, num_groups) for m in mask]
    return tuple(torch.stack(o) for o in zip(*outs))


def partition_histogram_lanes_plain(dest, mask, num_partitions: int):
    return torch.stack([partition_histogram_plain(dest, m, num_partitions) for m in mask])


def filtered_group_sum_lanes(codes, values, mask, num_groups: int):
    """K1 over the lanes of ``mask`` [G, N] -> (counts int64 [G, ng], sums
    float32 [G, ng])."""
    _check_lanes(codes, mask, num_groups, values)
    if codes.device.type == "cpu":
        return filtered_group_sum_lanes_plain(codes, values, mask, num_groups)
    return _launch_lanes("filtered_group_sum", KIND_SUM, codes, values, mask, num_groups)


def fused_group_aggregate_lanes(codes, values, mask, num_groups: int):
    """K2 over the lanes of ``mask`` [G, N] -> (counts int64, sums, mins,
    maxs float32), each [G, ng]."""
    _check_lanes(codes, mask, num_groups, values)
    if codes.device.type == "cpu":
        return fused_group_aggregate_lanes_plain(codes, values, mask, num_groups)
    return _launch_agg_lanes(codes, values, mask, num_groups)


def partition_histogram_lanes(dest, mask, num_partitions: int):
    """K3 over the lanes of ``mask`` [G, N] -> counts int64 [G, P]."""
    _check_lanes(dest, mask, num_partitions)
    if dest.device.type == "cpu":
        return partition_histogram_lanes_plain(dest, mask, num_partitions)
    return _launch_lanes("partition_histogram", KIND_HIST, dest, None, mask,
                         num_partitions)[0]


def _check_lanes(codes, mask, num_groups: int, values=None) -> None:
    """Raise on what the lane kernels do not take: ``mask`` must be bool
    [G, N] with 1 <= G <= 65535, contiguous, beside ``codes`` [N]."""
    if mask.dtype is not torch.bool or mask.ndim != 2 or mask.shape[1:] != codes.shape \
            or not 1 <= mask.shape[0] <= 65535:
        raise TypeError(f"mask must be bool[G, N] with 1 <= G <= 65535 beside codes "
                        f"{tuple(codes.shape)}, got {mask.dtype}{tuple(mask.shape)}")
    _check(codes, mask[0], num_groups, values)
    if mask.device != codes.device or not mask.is_contiguous():
        raise ValueError("mask must be contiguous and lie on the codes' device")


def lane_tiles(lanes: int, fit: int, tile: int | None = None) -> tuple[int, int]:
    """(lanes a block, tiles) for ``lanes`` lanes when a block holds at most
    ``fit``: the lanes spread evenly over the fewest tiles, the last tile
    the shorter; ``tile`` forces the lanes a block."""
    if tile is None:
        tile = -(-lanes // -(-lanes // fit))
    elif not 1 <= tile <= fit:
        raise ValueError(f"lane tile {tile} outside [1, {fit}]")
    return tile, -(-lanes // tile)


class LanePlan(NamedTuple):
    table_bytes: int     # one lane's table in shared memory
    fit: int             # lanes whose tables fit a block
    tile: int            # lanes a block carries
    tiles: int           # blocks a row-block becomes


def lane_plan(kind: int, num_groups: int, lanes: int, tile: int | None = None) -> LanePlan:
    """The lane tiles of K1/K3 and of K2 (``KIND_AGG``): a lane's table is
    ``num_groups`` uint32 counts (and float64 sums for K1; float64 sums,
    int32 (min, max) pairs and uint32 counts, 20 bytes a slot, for K2) in
    whole words; as many as fit ``LANE_SMEM_MAX``, at most ``LANE_TILE_MAX``
    (K2 ``AGG_LANE_MAX``) (csrc/group_agg.cu lane_table_bytes,
    agg_lane_table_bytes)."""
    per_slot = {KIND_HIST: 4, KIND_SUM: 12, KIND_AGG: 20}[kind]
    nbytes = -(-per_slot * int(num_groups) // 8) * 8
    most = AGG_LANE_MAX if kind == KIND_AGG else LANE_TILE_MAX
    fit = min(most, LANE_SMEM_MAX // nbytes)
    return LanePlan(nbytes, fit, *lane_tiles(lanes, fit, tile))


def _launch_lanes(name, kind, codes, values, mask, ng: int, tile: int | None = None):
    """K1/K3 over G lanes in the tiles of ``lane_plan`` (``tile`` forces the
    lanes a block): one int64 [1 or 3, G * ng] buffer laid out as the
    one-lane call's, each row holding the lanes one after another."""
    lib = _library()
    dev = codes.device
    G, n = mask.shape
    slots = G * ng
    tile = lane_plan(kind, ng, G, tile).tile
    buf = torch.empty((1 if kind == KIND_HIST else 3, slots), dtype=torch.int64, device=dev)
    base = buf.data_ptr()
    err = lib.bk_group_agg_lanes(
        _device_index(dev), kind, int(values is not None and values.dtype is torch.float64),
        codes.data_ptr(), None if values is None else values.data_ptr(), mask.data_ptr(),
        n, ng, G, tile, base, None if kind == KIND_HIST else base + 8 * slots,
        None if kind == KIND_HIST else base + 16 * slots,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}_lanes: CUDA kernel launch failed with error {err}")
    LANE_LAUNCHES[f"{name}_lanes"].add(1)
    if kind == KIND_HIST:
        return (buf[0].view(G, ng),)
    return buf[0].view(G, ng), buf[2].view(torch.float32)[:slots].view(G, ng)


def _launch_agg_lanes(codes, values, mask, ng: int, tile: int | None = None):
    """K2 over G lanes in the tiles of ``lane_plan(KIND_AGG, ...)``
    (``tile`` forces the lanes a block): one int64 buffer of the [G, ng]
    counts, the float32 [G, 3, ng] outputs (rounded up to whole words) and
    the workspace, one table a lane and row-block."""
    lib = _library()
    dev = codes.device
    device = _device_index(dev)
    f64 = int(values.dtype is torch.float64)
    G, n = mask.shape
    tile = lane_plan(KIND_AGG, ng, G, tile).tile
    rows = lib.bk_fused_agg_lane_rows(device, f64, n, ng, G, tile)
    if rows <= 0:
        raise RuntimeError(f"fused_group_aggregate_lanes: launch geometry failed with error "
                           f"{-rows}")
    fwords = -(-3 * G * ng // 2)
    ws_words = -(-lib.bk_fused_agg_ws_bytes(G * rows, ng) // 8)
    buf = torch.empty(G * ng + fwords + ws_words, dtype=torch.int64, device=dev)
    base = buf.data_ptr()
    err = lib.bk_fused_agg_lanes(device, f64, codes.data_ptr(), values.data_ptr(),
                                 mask.data_ptr(), n, ng, G, tile, rows,
                                 base + 8 * (G * ng + fwords), base, base + 8 * G * ng,
                                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_group_aggregate_lanes: CUDA kernel launch failed with "
                           f"error {err}")
    LANE_LAUNCHES["fused_group_aggregate_lanes"].add(1)
    f = buf[G * ng:G * ng + fwords].view(torch.float32)[:3 * G * ng].view(G, 3, ng)
    return buf[:G * ng].view(G, ng), f[:, 0], f[:, 1], f[:, 2]


# ----------------------------------------------------------------------
# build + bind


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _target(source: str) -> tuple[str, str]:
    """(shared library, compiler log) paths of ``source``'s build, keyed by
    its content."""
    with open(source, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    stem = os.path.splitext(os.path.basename(source))[0]
    return (os.path.join(BUILD_DIR, f"lib{stem}_{tag}.so"),
            os.path.join(BUILD_DIR, f"{stem}_{tag}.log"))


def _start(source: str):
    """Start ``nvcc`` on ``source`` for sm_90a unless its library exists;
    -> (library path, process or None)."""
    so, _ = _target(source)
    if os.path.exists(so):
        return so, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           *_SOURCE_FLAGS.get(source, ()), "-o", f"{so}.{os.getpid()}.tmp", source]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)


def _finish(source: str, so: str, proc) -> str:
    """Wait for ``proc``, keep its register and shared-memory report in the
    ``.log`` beside the library, and move the library into place."""
    if proc is None:
        return so
    out, err = proc.communicate()
    with open(_target(source)[1], "w") as f:
        f.write(" ".join(proc.args) + "\n" + out + err)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {source}:\n"
                           f"{err[-4000:]}")
    os.replace(f"{so}.{os.getpid()}.tmp", so)
    return so


def build(source: str = SOURCE) -> str:
    """Compile ``source`` (by default ``csrc/group_agg.cu``) for sm_90a into
    ``BUILD_DIR`` (once per source content) and return the shared library's
    path.  The compiler's register and shared-memory report lands beside it
    in a ``.log``."""
    return _finish(source, *_start(source))


def build_all() -> dict:
    """Every source of ``SOURCES``, one ``nvcc`` each, all started together
    -> {name: library path}."""
    started = {name: (src, *_start(src)) for name, src in SOURCES.items()}
    return {name: _finish(src, so, proc) for name, (src, so, proc) in started.items()}


def library(source: str, bind):
    """The library built from ``source``, loaded once and bound by
    ``bind(lib)`` (argument and result types)."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(build(source))
            bind(lib)
            _libs[source] = lib
        return lib


def _bind(lib) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bk_group_agg.argtypes = [i32, i32, i32, vp, vp, vp, i64, i32] + [vp] * 4
    lib.bk_group_agg.restype = i32
    lib.bk_fused_agg_blocks.argtypes = [i32, i32, i64, i32]
    lib.bk_fused_agg_blocks.restype = i32
    lib.bk_fused_agg_ws_bytes.argtypes = [i32, i32]
    lib.bk_fused_agg_ws_bytes.restype = i64
    lib.bk_fused_agg.argtypes = [i32, i32, vp, vp, vp, i64, i32, i32, vp, vp, vp, vp]
    lib.bk_fused_agg.restype = i32
    lib.bk_group_agg_lanes.argtypes = [i32, i32, i32, vp, vp, vp, i64, i32, i32, i32] + [vp] * 4
    lib.bk_group_agg_lanes.restype = i32
    lib.bk_group_agg_lane_table_bytes.argtypes = [i32, i32]
    lib.bk_group_agg_lane_table_bytes.restype = i64
    lib.bk_group_agg_lane_tile_max.restype = i32
    lib.bk_group_agg_lane_smem_max.restype = i64
    if (lib.bk_group_agg_lane_tile_max(), lib.bk_group_agg_lane_smem_max()) != \
            (LANE_TILE_MAX, LANE_SMEM_MAX):
        raise RuntimeError("csrc/group_agg.cu and ops/group_kernels.py disagree on "
                           "LANE_TILE_MAX or LANE_SMEM_MAX")
    lib.bk_fused_agg_lane_rows.argtypes = [i32, i32, i64, i32, i32, i32]
    lib.bk_fused_agg_lane_rows.restype = i32
    lib.bk_fused_agg_lanes.argtypes = [i32, i32, vp, vp, vp, i64, i32, i32, i32, i32, vp, vp, vp,
                                       vp]
    lib.bk_fused_agg_lanes.restype = i32
    lib.bk_fused_agg_lane_table_bytes.argtypes = [i32]
    lib.bk_fused_agg_lane_table_bytes.restype = i64
    lib.bk_fused_agg_lane_max.restype = i32
    if lib.bk_fused_agg_lane_max() != AGG_LANE_MAX:
        raise RuntimeError("csrc/group_agg.cu and ops/group_kernels.py disagree on AGG_LANE_MAX")


def _library():
    return library(SOURCE, _bind)
