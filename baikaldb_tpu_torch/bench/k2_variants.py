"""What holds K2 (``fused_group_aggregate``) on the card: build variants of
``ops/csrc/group_agg.cu`` that each change or drop one piece of the
kernel, and time them in turns on the same inputs.

    python -m baikaldb_tpu_torch.bench.k2_variants [--rows N] [--seed S]

Variants (text substitutions on the shipped source, built with nvcc into
``baikaldb_tpu_torch/_build/variants/``):

- ``shipped``: the kernel as it is.
- ``no_prefetch``: each step loads its own quads right before its atomics,
  instead of loading the next step's before this step's atomics.
- ``unconditional_minmax``: the min/max atomics run on every live row,
  without first reading the slot's (min, max) pair.
- ``no_sum`` (diagnostic, wrong sums): the float64 shared-memory add dropped.
- ``loads_only`` (diagnostic, wrong results): a row passes only if its value
  is 1234.5, so every load stays and almost no atomic runs; the floor the
  loads alone set.

The real variants are held against the plain version first.  Each is timed
as ``device_ms``: CUDA events around 20 back-to-back calls over 20, in turns
(all variants, then all again in reverse).  Three calls of the shipped
kernel run under torch.profiler to split its time between ``agg_kernel``
and ``agg_merge``, and ``cuobjdump -sass`` lists the shared-memory atomics
each variant compiled to.  The last line of standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

from ..ops import group_kernels as gk

LOOP = """    Step cur, next;
    cur.load(c4, m4, vq, warp * WARP_QUADS, quads, lane);
    for (long long base = warp * WARP_QUADS; base < quads; base += step) {
        // the next step's loads go out before this step's atomics
        next.load(c4, m4, vq, base + step, quads, lane);
        cur.add(t, ng);
        cur = next;
    }"""
CHECKED = """    const int2 e = t.ext[g];
    if (k < e.x) atomicMin(&t.ext[g].x, k);
    if (k > e.y) atomicMax(&t.ext[g].y, k);"""
SUM = "    atomicAdd(&t.sums[g], static_cast<double>(v));"
KEEP = ("    if (!keep || static_cast<unsigned int>(g) >= static_cast<unsigned int>(ng)) "
        "return;")
VARIANTS = {
    "shipped": [],
    "no_prefetch": [(LOOP, """    for (long long base = warp * WARP_QUADS; base < quads; base += step) {
        Step cur;
        cur.load(c4, m4, vq, base, quads, lane);
        cur.add(t, ng);
    }""")],
    "unconditional_minmax": [(CHECKED, """    atomicMin(&t.ext[g].x, k);
    atomicMax(&t.ext[g].y, k);""")],
    "no_sum": [(SUM, "")],
    "loads_only": [(KEEP, KEEP.replace(") return;", " || v != 1234.5f) return;"))],
}
DIAGNOSTIC = ("no_sum", "loads_only")


class Variant:
    """One variant's shared library, bound like ``group_kernels``' K2."""

    def __init__(self, path: str):
        lib = ctypes.CDLL(path)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bk_fused_agg_blocks.argtypes = [i32, i32, i64, i32]
        lib.bk_fused_agg_ws_bytes.argtypes = [i32, i32]
        lib.bk_fused_agg_ws_bytes.restype = i64
        lib.bk_fused_agg.argtypes = [i32, i32, vp, vp, vp, i64, i32, i32, vp, vp, vp, vp]
        self.lib = lib

    def __call__(self, codes, values, mask, ng: int):
        lib, n = self.lib, codes.shape[0]
        blocks = lib.bk_fused_agg_blocks(0, 0, n, ng)
        if blocks <= 0:
            raise RuntimeError(f"launch geometry failed with error {-blocks}")
        fwords = -(-3 * ng // 2)
        ws_words = -(-lib.bk_fused_agg_ws_bytes(blocks, ng) // 8)
        buf = torch.empty(ng + fwords + ws_words, dtype=torch.int64, device=codes.device)
        base = buf.data_ptr()
        err = lib.bk_fused_agg(0, 0, codes.data_ptr(), values.data_ptr(), mask.data_ptr(), n,
                               ng, blocks, base + 8 * (ng + fwords), base, base + 8 * ng,
                               torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed with error {err}")
        f = buf[ng:ng + fwords].view(torch.float32)
        return buf[:ng], f[:ng], f[ng:2 * ng], f[2 * ng:3 * ng]


def build(out_dir: str) -> dict[str, str]:
    """All variants, one nvcc each, started together -> {name: .so path}."""
    src = open(gk.SOURCE).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: its anchor is gone from {gk.SOURCE}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"k2_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"k2_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [gk._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log[-4000:]}")
        out[name] = so
    return out


def shared_atomics(so: str) -> list[str]:
    """The shared-memory atomic opcodes of ``agg_kernel<float>`` in the SASS."""
    tool = os.path.join(os.path.dirname(gk._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    part = next(sec for sec in sass.split("Function : ")
                if "agg_kernelIf" in sec.split("\n", 1)[0])
    ops = set()
    for line in part.splitlines():
        if "ATOMS" in line and "*/" in line:
            ops.add(next(t for t in line.split("*/", 1)[1].split() if not t.startswith("@")))
    return sorted(ops)


def device_ms(fn, launches: int = 20, runs: int = 3) -> float:
    fn()
    per_call = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / launches)
    return statistics.median(per_call)


def parts_ms(fn, calls: int = 3) -> dict[str, float]:
    """Device milliseconds a call of each CUDA kernel, over ``calls``
    profiled calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3 / e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = build(os.path.join(gk.BUILD_DIR, "variants"))
    atomics = {name: shared_atomics(so) for name, so in libs.items()}
    kernels = {name: Variant(so) for name, so in libs.items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    times, parts = {}, {}
    for ng in (2049, 513, 4096):
        codes = torch.randint(0, ng, (args.rows,), generator=gen, device=dev,
                              dtype=torch.int32)
        values = torch.randn(args.rows, generator=gen, device=dev)
        mask = torch.rand(args.rows, generator=gen, device=dev) < 0.6
        want = gk.fused_group_aggregate_plain(codes, values, mask, ng)
        for name, k in kernels.items():
            if name in DIAGNOSTIC:
                continue
            got = k(codes, values, mask, ng)
            for i in (0, 2, 3):
                if not torch.equal(got[i], want[i]):
                    raise AssertionError(f"variant {name} differs from the plain version "
                                         f"(output {i}, ng={ng})")
            torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
        t = {name: [] for name in kernels}
        order = list(kernels)
        for turn in (order, order[::-1]):
            for name in turn:
                t[name].append(device_ms(lambda: kernels[name](codes, values, mask, ng)))
        times[ng] = t
        parts[ng] = parts_ms(lambda: kernels["shipped"](codes, values, mask, ng))
        for name, ms in t.items():
            print(f"ng={ng} {name:22s} device ms {ms[0]:.4f} {ms[1]:.4f}", file=sys.stderr)
        del codes, values, mask, want
    print(json.dumps({"card": card, "rows": args.rows, "device_ms": times,
                      "shipped_parts_ms": parts, "shared_atomics": atomics}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
