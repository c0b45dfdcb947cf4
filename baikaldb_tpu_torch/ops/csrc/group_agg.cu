// Fused filter + dense GROUP BY kernels for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of baikaldb_tpu/ops/pallas_kernels.py:
//   KIND_HIST (K3) -> partition_histogram   (:238, _hist_kernel): per-group row counts
//   KIND_SUM  (K1) -> filtered_group_sum    (:184, _sum_kernel):  counts + sums
//   K2             -> fused_group_aggregate (:210, _agg_kernel):  counts + sums + min + max
// The contract is the TPU kernels': codes int32[N], values [N] contracted as
// float32, mask bool[N]; a row drops when its mask is false or its code lies
// outside [0, ng).  Counts are int64[ng], exact at any row count; sums, mins
// and maxs are float32[ng]; an empty group's min/max hold
// +3.4e38 / -3.4e38 and its count of 0 marks it.  A group holding a NaN (of
// either sign) gives NaN for SUM, MIN and MAX, as the JAX package's SQL
// answer and the plain versions do.
//
// What bounds all three: one read of codes (4 B), values (4 or 8 B) and mask
// (1 B) per row, so device-memory bandwidth.  The TPU kernels' bf16
// three-way split and Kahan row work around its matrix unit and do not carry
// over: on Hopper the work is a data-dependent scatter into a private
// shared-memory table of ng <= 4096 slots per block.  Tables keep counts in
// uint32, sums in float64 (no compensation needed at these sizes) and
// min/max as order-preserving int32 images of the float32 value, so integer
// atomicMin/atomicMax order floats.
//
// K1 and K3 (group_agg_kernel): each thread loads one row a step,
// grid-stride; one block flushes its table into a global workspace with
// global atomics after init_workspace.  The uint64 workspace counts are the
// int64 count output as they stand; for K1, finalize rounds the float64
// workspace sums to the float32 outputs.
//
// K2 (agg_kernel + agg_merge), redesigned for this card:
// - Wide, early loads.  A warp takes 64 quads (a quad is 4 consecutive
//   rows) a step; lane l loads quads l and l+32, each as an int4 of codes, a
//   float4 of values (two double2 for float64) and the 4 mask bytes as one
//   uint32, so every load instruction of the warp reads one contiguous span.
//   The next step's loads go out before this step's atomics, so a lane keeps
//   up to 16 rows (~140 B) in flight, which the one-row-a-step loop of K1/K3
//   cannot.  Rows before the codes' first 16-byte boundary (the head)
//   and after the last whole quad (the tail) take a scalar loop.  If values
//   or mask are not aligned at that same row (a view at another element
//   offset), the whole call takes the scalar loop.
// - NaN costs no extra state: a NaN enters the max atomic as INT_MAX, above
//   the image of every float and the image of none, so a slot whose max is
//   INT_MAX holds a NaN; the flag travels with the max through the merge and
//   agg_merge writes NaN to both MIN and MAX.  SUM turns NaN by arithmetic.
// - Cross-block merge without contended atomics: each block stores its table
//   to its own row of a [blocks x ng] workspace with plain coalesced stores;
//   agg_merge reduces the rows of each slot (in a fixed order) and writes
//   the float32 outputs.  Two launches, no init pass.
// - Shared-memory work per live row: a count atomic, the float64 add (a
//   compare-and-swap loop in SASS: sm_90 has no native shared f64 add), and
//   one 8-byte read of the (min, max) pair; the min/max atomics run only
//   when the value lies outside it, which after a slot's first few rows is
//   rare.
// What bounds K2 as built (baikaldb_tpu_torch/bench/k2_variants.py, H100 SXM
// at 700 W, 100M rows, 2049 groups): its loads alone take ~0.30 ms (~3 TB/s;
// every 32-byte sector of values is read although only live rows' values
// count), and the float64 compare-and-swap loop adds ~0.05 ms that the loads
// do not hide.  A TMA ring was not tried: the loads already run near the
// memory rate, and it would add shared-memory traffic to the pipe the
// atomics use.
//
// Lanes: one launch serves the G lanes of a batched-dispatch tick.  codes
// and values are shared, mask is [G, n] (row L is lane L's filter), the
// outputs are [G, ng].
// - K1/K3 (bk_group_agg_lanes, group_agg_lanes_kernel): block (tile, r)
//   carries a tile of up to LANE_TILE_MAX lanes, one table each side by side
//   in shared memory (tile * table <= 227 KB; ops/group_kernels.py
//   lane_plan picks the tile), and takes row-block r.  It loads each quad's
//   codes and values once (an int4 and a float4 or two double2, as K2 does),
//   and for each lane of the tile that lane's 4 mask bytes as one uint32
//   (four byte loads where the lane's mask row is not 4-byte aligned there:
//   a ragged n), and updates that lane's table.  The tiles of a row-block
//   are adjacent in the grid (tile is blockIdx.x), so they run together and
//   the later ones read codes and values from L2; the grid is one wave.
//   Counts are exact; sums are float64 atomics in another order than the
//   one-lane call's, rounded once to float32 by finalize.  Device-memory
//   bytes: G * n mask bytes + about one read of codes and values.  What
//   bounds it on the H100 is the shared-memory atomics a live row makes in
//   every lane: K3's count, and K1's float64 add, a compare-and-swap loop
//   (K1 reaches under a fifth of its byte bound at 8 lanes, K3 half).
// - K2 (bk_fused_agg_lanes, agg_lanes_kernel + agg_merge): block (tile, r)
//   carries the K2 tables (20 bytes a slot) of up to AGG_LANE_MAX lanes in
//   shared memory (4 at 2049 slots, 2 at 4096) and takes row-block r in
//   chunks of two quads a thread.  Loads as K1/K3's tile: each quad's codes
//   and values once for the tile, each lane's mask word once, a ragged n
//   through four byte loads.  The tables fill the SM's shared memory, so a
//   block is alone on its SM (16 warps), and each thread keeps the loads of
//   two chunks in flight while it updates the tables from a third (one
//   chunk in flight took 1.2x as long at D-b's masks).  A live row-lane takes
//   the one-lane kernel's update (agg_row: a count atomic, the float64
//   compare-and-swap add, the (min, max) read).  A slot-owned update (each
//   chunk bucketed by slot with one uint32 atomic a row, each thread folding
//   its slots' rows in registers with no compare-and-swap) and staged runs
//   of one slot were built and measured no faster at 60% live and slower at
//   D-b's 2% (PERF.md, section 6): their scan, staging and barriers cost what
//   the compare-and-swap loops they remove cost, at ~2 rows a slot a chunk.
//   Each block stores its lanes' tables to rows (lane, r) of a [lanes,
//   row-blocks, ng] workspace, which agg_merge reduces per (lane, slot) in a
//   fixed order.  Counts and MIN/MAX are exact; sums are float64 partials in
//   another order than the one-lane call's, rounded once.  Device-memory
//   bytes: G * n mask bytes + about one read of codes and values (the tiles
//   of a row-block read them from L2).  What bounds it: the loads reach
//   about 1.7 TB/s of L1 fills at one block an SM, and at 60% live the
//   compare-and-swap loops a live row-lane, which 16 warps hide worse than
//   the one-lane kernel's 32.
//
// Host side: the dynamic-shared-memory attribute, the SM count and the
// occupancy answer are queried once per (kernel, device, table size) and
// cached; every launch still returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (baikaldb_tpu_torch/ops/group_kernels.py does it).
// Interface: plain C, loaded with ctypes; pointers are device pointers, the
// stream is PyTorch's current stream; the return value is a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int KIND_HIST = 0;
constexpr int KIND_SUM = 1;
constexpr int MAX_GROUPS = 4096;
constexpr int THREADS = 512;
constexpr float BIG = 3.4e38f;   // the TPU kernels' empty-group sentinel

constexpr int AGG_THREADS = 512;
constexpr int AGG_QUADS = 2;          // quads a lane loads a step
constexpr int WARP_QUADS = 32 * AGG_QUADS;
constexpr int NAN_KEY = 0x7FFFFFFF;   // max-slot image of a NaN
constexpr int LANE_TILE_MAX = 16;     // lanes one block of group_agg_lanes_kernel carries
constexpr size_t LANE_SMEM_MAX = 232448;   // 227 KB: one block's shared memory on sm_90
constexpr int MERGE_SLOTS = 32;       // slots of one agg_merge block, one a lane
constexpr int MERGE_WARPS = 16;       // warps of one agg_merge block, splitting the rows
constexpr int AGG_LANE_MAX = 4;       // lanes one block of agg_lanes_kernel carries
constexpr int CHUNK_QUADS = 2 * AGG_THREADS;   // quads agg_lanes_kernel loads at a time

// float32 -> int32 whose signed order is the float order (NaN aside).
__device__ __forceinline__ int ordered_int(float v) {
    int i = __float_as_int(v);
    return i >= 0 ? i : i ^ 0x7FFFFFFF;
}

__device__ __forceinline__ float ordered_float(int i) {
    return __int_as_float(i >= 0 ? i : i ^ 0x7FFFFFFF);
}

// Shared-memory table layout for ng slots (sums first: 8-byte aligned).
__host__ __device__ inline size_t table_bytes(int kind, int ng) {
    size_t b = sizeof(unsigned int) * ng;                        // counts
    if (kind != KIND_HIST) b += sizeof(double) * ng;             // sums
    return b;
}

// One lane's table in group_agg_lanes_kernel: table_bytes in whole words.
__host__ __device__ inline size_t lane_table_bytes(int kind, int ng) {
    return (table_bytes(kind, ng) + 7) & ~static_cast<size_t>(7);
}

// K2's table: sums, (min, max) pairs, counts.
__host__ __device__ inline size_t agg_table_bytes(int ng) {
    return (sizeof(double) + sizeof(int2) + sizeof(unsigned int)) * ng;
}

// One lane's table in agg_lanes_kernel: agg_table_bytes in whole words.
__host__ __device__ inline size_t agg_lane_table_bytes(int ng) {
    return (agg_table_bytes(ng) + 7) & ~static_cast<size_t>(7);
}

__global__ void init_workspace(int kind, int ng, unsigned long long* counts, double* sums) {
    int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= ng) return;
    counts[g] = 0ULL;
    if (kind != KIND_HIST) sums[g] = 0.0;
}

template <int KIND, typename V>
__global__ void __launch_bounds__(THREADS)
group_agg_kernel(const int* __restrict__ codes, const V* __restrict__ values,
                 const bool* __restrict__ mask, long long n, int ng,
                 unsigned long long* g_counts, double* g_sums) {
    extern __shared__ __align__(8) unsigned char smem[];
    double* s_sums = reinterpret_cast<double*>(smem);
    unsigned int* s_counts = reinterpret_cast<unsigned int*>(
        smem + (KIND != KIND_HIST ? sizeof(double) * ng : 0));

    for (int g = threadIdx.x; g < ng; g += blockDim.x) {
        s_counts[g] = 0u;
        if (KIND != KIND_HIST) s_sums[g] = 0.0;
    }
    __syncthreads();

    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        const int g = codes[i];
        if (!mask[i] || g < 0 || g >= ng) continue;
        atomicAdd(&s_counts[g], 1u);
        if (KIND != KIND_HIST) {
            const float v = static_cast<float>(values[i]);
            atomicAdd(&s_sums[g], static_cast<double>(v));
        }
    }
    __syncthreads();

    for (int g = threadIdx.x; g < ng; g += blockDim.x) {
        const unsigned int c = s_counts[g];
        if (c == 0u) continue;
        atomicAdd(&g_counts[g], static_cast<unsigned long long>(c));
        if (KIND != KIND_HIST) atomicAdd(&g_sums[g], s_sums[g]);
    }
}

// ---------------------------------------------------------------------------
// K1/K3 over a tile of lanes

template <int KIND>
__device__ __forceinline__ void lane_row(unsigned char* table, int ng, int g, float v) {
    unsigned int* counts = reinterpret_cast<unsigned int*>(
        table + (KIND != KIND_HIST ? sizeof(double) * ng : 0));
    atomicAdd(&counts[g], 1u);
    if (KIND != KIND_HIST) atomicAdd(&reinterpret_cast<double*>(table)[g], static_cast<double>(v));
}

// A quad of values as float32, left in L2 for the row-block's other tiles.
__device__ __forceinline__ void load_quad_keep(const float* p, float v[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load_quad_keep(const double* p, float v[4]) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p));
    const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
    v[0] = static_cast<float>(a.x); v[1] = static_cast<float>(a.y);
    v[2] = static_cast<float>(b.x); v[3] = static_cast<float>(b.y);
}

// A lane's 4 mask bytes of one quad, byte r in bits 8r..8r+7.
__device__ __forceinline__ unsigned int mask_quad(const bool* m, bool aligned) {
    if (aligned) return __ldcs(reinterpret_cast<const unsigned int*>(m));
    const unsigned char* b = reinterpret_cast<const unsigned char*>(m);
    return static_cast<unsigned int>(b[0]) | static_cast<unsigned int>(b[1]) << 8 |
           static_cast<unsigned int>(b[2]) << 16 | static_cast<unsigned int>(b[3]) << 24;
}

// The quad one thread holds in one step: codes, values, and a mask word per
// lane of the tile.
template <int KIND, typename V>
struct LaneQuad {
    int4 c;
    float v[4];
    unsigned int m[LANE_TILE_MAX];

    __device__ __forceinline__ void load(const int4* c4, const V* vq, const bool* mask,
                                         long long n, long long quads, int nl,
                                         unsigned int aligned, long long q) {
        if (q >= quads) {
            c = make_int4(-1, -1, -1, -1);
#pragma unroll
            for (int l = 0; l < LANE_TILE_MAX; ++l) m[l] = 0u;
            return;
        }
        c = __ldg(c4 + q);      // kept in L2 for the row-block's other tiles
        if (KIND != KIND_HIST) load_quad_keep(vq + 4 * q, v);
        else v[0] = v[1] = v[2] = v[3] = 0.f;
#pragma unroll
        for (int l = 0; l < LANE_TILE_MAX; ++l)
            m[l] = l < nl ? mask_quad(mask + static_cast<size_t>(l) * n + 4 * q,
                                      (aligned >> l) & 1u)
                          : 0u;
    }

    __device__ __forceinline__ void add(unsigned char* smem, size_t lane_bytes, int ng,
                                        int nl) const {
        const int g[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int l = 0; l < LANE_TILE_MAX; ++l) {
            if (l >= nl) break;
            unsigned char* table = smem + l * lane_bytes;
#pragma unroll
            for (int r = 0; r < 4; ++r)
                if (((m[l] >> (8 * r)) & 0xFFu) != 0u &&
                    static_cast<unsigned int>(g[r]) < static_cast<unsigned int>(ng))
                    lane_row<KIND>(table, ng, g[r], v[r]);
        }
    }
};

// Block (tile, r): the lanes [tile * lt, min(lanes, (tile + 1) * lt)) over
// row-block r.  Rows [head, head + 4 * quads) go through the quad loop, the
// rest through the scalar one; each lane's table is flushed into its row of
// the [lanes, ng] workspace with global atomics.
template <int KIND, typename V>
__global__ void __launch_bounds__(THREADS)
group_agg_lanes_kernel(const int* __restrict__ codes, const V* __restrict__ values,
                       const bool* __restrict__ mask, long long n, long long head,
                       long long quads, int ng, int lanes, int lt,
                       unsigned long long* g_counts, double* g_sums) {
    extern __shared__ __align__(8) unsigned char smem[];
    const int first = blockIdx.x * lt;
    const int nl = min(lt, lanes - first);
    const size_t lane_bytes = lane_table_bytes(KIND, ng);
    const size_t count_off = KIND != KIND_HIST ? sizeof(double) * ng : 0;
    for (int i = threadIdx.x; i < nl * ng; i += THREADS) {
        const int l = i / ng, g = i - l * ng;
        unsigned char* table = smem + l * lane_bytes;
        reinterpret_cast<unsigned int*>(table + count_off)[g] = 0u;
        if (KIND != KIND_HIST) reinterpret_cast<double*>(table)[g] = 0.0;
    }
    __syncthreads();

    mask += static_cast<size_t>(first) * n;
    unsigned int aligned = 0u;      // lanes whose mask row is 4-byte aligned at `head`
    for (int l = 0; l < nl; ++l)
        if ((reinterpret_cast<uintptr_t>(mask + static_cast<size_t>(l) * n + head) & 3u) == 0)
            aligned |= 1u << l;
    const long long stride = (long long)gridDim.y * THREADS;
    const int4* c4 = reinterpret_cast<const int4*>(codes + head);
    const V* vq = KIND != KIND_HIST ? values + head : nullptr;
    LaneQuad<KIND, V> cur, next;
    long long q = (long long)blockIdx.y * THREADS + threadIdx.x;
    cur.load(c4, vq, mask + head, n, quads, nl, aligned, q);
    for (; q < quads; q += stride) {
        // the next step's loads go out before this step's atomics
        next.load(c4, vq, mask + head, n, quads, nl, aligned, q + stride);
        cur.add(smem, lane_bytes, ng, nl);
        cur = next;
    }

    // scalar rows: the head [0, head) and the tail [head + 4 * quads, n)
    const long long tail = head + 4 * quads;
    const long long scalar_rows = head + (n - tail);
    for (long long k = (long long)blockIdx.y * THREADS + threadIdx.x; k < scalar_rows;
         k += stride) {
        const long long i = k < head ? k : tail + (k - head);
        const int g = codes[i];
        if (g < 0 || g >= ng) continue;
        const float v = KIND != KIND_HIST ? static_cast<float>(values[i]) : 0.f;
        for (int l = 0; l < nl; ++l)
            if (mask[static_cast<size_t>(l) * n + i]) lane_row<KIND>(smem + l * lane_bytes, ng, g, v);
    }
    __syncthreads();

    for (int i = threadIdx.x; i < nl * ng; i += THREADS) {
        const int l = i / ng, g = i - l * ng;
        const unsigned char* table = smem + l * lane_bytes;
        const unsigned int c = reinterpret_cast<const unsigned int*>(table + count_off)[g];
        if (c == 0u) continue;
        const size_t o = static_cast<size_t>(first + l) * ng + g;
        atomicAdd(&g_counts[o], static_cast<unsigned long long>(c));
        if (KIND != KIND_HIST) atomicAdd(&g_sums[o], reinterpret_cast<const double*>(table)[g]);
    }
}

__global__ void finalize(int ng, const double* sums, float* o_sums) {
    int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= ng) return;
    o_sums[g] = static_cast<float>(sums[g]);
}

// ---------------------------------------------------------------------------
// K2

struct AggTable {
    double* sums;
    int2* ext;                // (min, max) as ordered_int images
    unsigned int* counts;
};

__device__ __forceinline__ AggTable agg_table(void* base, size_t slots) {
    AggTable t;
    t.sums = static_cast<double*>(base);
    t.ext = reinterpret_cast<int2*>(t.sums + slots);
    t.counts = reinterpret_cast<unsigned int*>(t.ext + slots);
    return t;
}

__device__ __forceinline__ void agg_row(const AggTable& t, int ng, int g, bool keep, float v) {
    if (!keep || static_cast<unsigned int>(g) >= static_cast<unsigned int>(ng)) return;
    atomicAdd(&t.counts[g], 1u);
    atomicAdd(&t.sums[g], static_cast<double>(v));
    // min and max only move outward, so a pair read before another thread's
    // update can only skip an atomic that would change nothing
    const int k = v != v ? NAN_KEY : ordered_int(v);
    const int2 e = t.ext[g];
    if (k < e.x) atomicMin(&t.ext[g].x, k);
    if (k > e.y) atomicMax(&t.ext[g].y, k);
}

__device__ __forceinline__ void load_quad(const float* p, float v[4]) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load_quad(const double* p, float v[4]) {
    const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
    const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
    v[0] = static_cast<float>(a.x); v[1] = static_cast<float>(a.y);
    v[2] = static_cast<float>(b.x); v[3] = static_cast<float>(b.y);
}

// The quads a lane takes in one step of the vector loop: base + lane + 32 j.
struct Step {
    int4 c[AGG_QUADS];
    unsigned int m[AGG_QUADS];
    float v[AGG_QUADS][4];

    template <typename V>
    __device__ __forceinline__ void load(const int4* c4, const unsigned int* m4, const V* vq,
                                         long long base, long long quads, int lane) {
#pragma unroll
        for (int j = 0; j < AGG_QUADS; ++j) {
            const long long q = base + j * 32 + lane;
            if (q < quads) {
                c[j] = __ldcs(c4 + q);
                m[j] = __ldcs(m4 + q);
                load_quad(vq + 4 * q, v[j]);
            } else {
                c[j] = make_int4(0, 0, 0, 0);
                m[j] = 0u;
                v[j][0] = v[j][1] = v[j][2] = v[j][3] = 0.f;
            }
        }
    }

    __device__ __forceinline__ void add(const AggTable& t, int ng) const {
#pragma unroll
        for (int j = 0; j < AGG_QUADS; ++j) {
            agg_row(t, ng, c[j].x, (m[j] & 0xFFu) != 0u, v[j][0]);
            agg_row(t, ng, c[j].y, (m[j] & 0xFF00u) != 0u, v[j][1]);
            agg_row(t, ng, c[j].z, (m[j] & 0xFF0000u) != 0u, v[j][2]);
            agg_row(t, ng, c[j].w, (m[j] & 0xFF000000u) != 0u, v[j][3]);
        }
    }
};

// Rows [head, head + 4 * quads) go through the vector loop, the rest through
// the scalar one.  Each block leaves its table in row blockIdx.x of `ws`.
template <typename V>
__global__ void __launch_bounds__(AGG_THREADS, 2)
agg_kernel(const int* __restrict__ codes, const V* __restrict__ values,
           const bool* __restrict__ mask, long long n, long long head, long long quads,
           int ng, void* __restrict__ ws) {
    extern __shared__ __align__(8) unsigned char smem[];
    const AggTable t = agg_table(smem, ng);
    for (int g = threadIdx.x; g < ng; g += AGG_THREADS) {
        t.sums[g] = 0.0;
        t.ext[g] = make_int2(ordered_int(BIG), ordered_int(-BIG));
        t.counts[g] = 0u;
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const long long warp = ((long long)blockIdx.x * AGG_THREADS + threadIdx.x) >> 5;
    const long long step = (((long long)gridDim.x * AGG_THREADS) >> 5) * WARP_QUADS;
    const int4* c4 = reinterpret_cast<const int4*>(codes + head);
    const unsigned int* m4 = reinterpret_cast<const unsigned int*>(mask + head);
    const V* vq = values + head;
    Step cur, next;
    cur.load(c4, m4, vq, warp * WARP_QUADS, quads, lane);
    for (long long base = warp * WARP_QUADS; base < quads; base += step) {
        // the next step's loads go out before this step's atomics
        next.load(c4, m4, vq, base + step, quads, lane);
        cur.add(t, ng);
        cur = next;
    }

    // scalar rows: the head [0, head) and the tail [head + 4 * quads, n)
    const long long tail = head + 4 * quads;
    const long long scalar_rows = head + (n - tail);
    const long long stride = (long long)gridDim.x * AGG_THREADS;
    for (long long k = (long long)blockIdx.x * AGG_THREADS + threadIdx.x; k < scalar_rows;
         k += stride) {
        const long long i = k < head ? k : tail + (k - head);
        agg_row(t, ng, codes[i], mask[i], static_cast<float>(values[i]));
    }
    __syncthreads();

    const AggTable w = agg_table(ws, static_cast<size_t>(gridDim.x) * ng);
    const size_t row = static_cast<size_t>(blockIdx.x) * ng;
    for (int g = threadIdx.x; g < ng; g += AGG_THREADS) {
        w.sums[row + g] = t.sums[g];
        w.ext[row + g] = t.ext[g];
        w.counts[row + g] = t.counts[g];
    }
}

// Reduces the `blocks` rows of the workspace per slot; -> int64 counts and
// float32 outputs out[0:ng] sums, [ng:2ng] mins, [2ng:3ng] maxs.  Lane
// blockIdx.y reads its own `blocks` rows and writes counts[L * ng ...] and
// out[L * 3 * ng ...] (agg_kernel fills one lane, agg_lanes_kernel many).
__global__ void __launch_bounds__(MERGE_SLOTS * MERGE_WARPS)
agg_merge(int blocks, int ng, const void* __restrict__ ws, long long* __restrict__ counts,
          float* __restrict__ out) {
    __shared__ double s_sums[MERGE_WARPS][MERGE_SLOTS];
    __shared__ unsigned long long s_counts[MERGE_WARPS][MERGE_SLOTS];
    __shared__ int s_mins[MERGE_WARPS][MERGE_SLOTS];
    __shared__ int s_maxs[MERGE_WARPS][MERGE_SLOTS];
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    const int g = blockIdx.x * MERGE_SLOTS + lane;
    const size_t first = static_cast<size_t>(blockIdx.y) * blocks;
    const AggTable w = agg_table(const_cast<void*>(ws),
                                 static_cast<size_t>(gridDim.y) * blocks * ng);
    counts += static_cast<size_t>(blockIdx.y) * ng;
    out += static_cast<size_t>(blockIdx.y) * 3 * ng;
    double s = 0.0;
    unsigned long long c = 0ULL;
    int mn = ordered_int(BIG), mx = ordered_int(-BIG);
    if (g < ng) {
#pragma unroll 4
        for (int b = wid; b < blocks; b += MERGE_WARPS) {
            const size_t i = (first + b) * ng + g;
            const int2 e = w.ext[i];
            s += w.sums[i];
            c += w.counts[i];
            mn = min(mn, e.x);
            mx = max(mx, e.y);
        }
    }
    s_sums[wid][lane] = s;
    s_counts[wid][lane] = c;
    s_mins[wid][lane] = mn;
    s_maxs[wid][lane] = mx;
    __syncthreads();
    if (wid != 0 || g >= ng) return;
    for (int k = 1; k < MERGE_WARPS; ++k) {
        s += s_sums[k][lane];
        c += s_counts[k][lane];
        mn = min(mn, s_mins[k][lane]);
        mx = max(mx, s_maxs[k][lane]);
    }
    counts[g] = static_cast<long long>(c);
    out[g] = static_cast<float>(s);
    const float nan = __int_as_float(0x7FC00000);
    out[ng + g] = mx == NAN_KEY ? nan : ordered_float(mn);
    out[2 * ng + g] = mx == NAN_KEY ? nan : ordered_float(mx);
}

// ---------------------------------------------------------------------------
// K2 over a tile of lanes

// The two quads one thread takes in a chunk (quads q and q + AGG_THREADS):
// codes, values and one mask word a lane of the tile, as loaded.
struct ChunkQuads {
    int4 c[2];
    float v[2][4];
    unsigned int m[2][AGG_LANE_MAX];

    template <typename V>
    __device__ __forceinline__ void load(const int4* c4, const V* vq, const bool* mask,
                                         long long n, long long quads, int nl,
                                         unsigned int aligned, long long q) {
#pragma unroll
        for (int j = 0; j < 2; ++j, q += AGG_THREADS) {
            if (q >= quads) {
                c[j] = make_int4(-1, -1, -1, -1);
#pragma unroll
                for (int l = 0; l < AGG_LANE_MAX; ++l) m[j][l] = 0u;
                continue;
            }
            c[j] = __ldg(c4 + q);       // kept in L2 for the row-block's other tiles
            load_quad_keep(vq + 4 * q, v[j]);
#pragma unroll
            for (int l = 0; l < AGG_LANE_MAX; ++l)
                m[j][l] = l < nl ? mask_quad(mask + static_cast<size_t>(l) * n + 4 * q,
                                             (aligned >> l) & 1u)
                                 : 0u;
        }
    }
};

// A quad's mask words, one a lane of the tile, as one word: byte r holds
// row r's lanes, one bit each.
__device__ __forceinline__ unsigned int quad_lanes(const unsigned int m[AGG_LANE_MAX]) {
    unsigned int packed = 0u;
#pragma unroll
    for (int l = 0; l < AGG_LANE_MAX; ++l) packed |= (__vcmpne4(m[l], 0u) & 0x01010101u) << l;
    return packed;
}

// Block (tile, r): the lanes [tile * lt, min(lanes, (tile + 1) * lt)) over
// the chunks r, r + R, ... of rows [head, head + 4 * quads); the other rows
// through the scalar loop.  Lane l's table lands in row (first + l) * R + r
// of the workspace.
template <typename V>
__global__ void __launch_bounds__(AGG_THREADS, 1)
agg_lanes_kernel(const int* __restrict__ codes, const V* __restrict__ values,
                 const bool* __restrict__ mask, long long n, long long head, long long quads,
                 int ng, int lanes, int lt, void* __restrict__ ws) {
    extern __shared__ __align__(8) unsigned char smem[];
    const int first = blockIdx.x * lt;
    const int nl = min(lt, lanes - first);
    const size_t lane_bytes = agg_lane_table_bytes(ng);
    for (int i = threadIdx.x; i < nl * ng; i += AGG_THREADS) {
        const int l = i / ng, g = i - l * ng;
        const AggTable t = agg_table(smem + l * lane_bytes, ng);
        t.sums[g] = 0.0;
        t.ext[g] = make_int2(ordered_int(BIG), ordered_int(-BIG));
        t.counts[g] = 0u;
    }
    __syncthreads();

    mask += static_cast<size_t>(first) * n;
    unsigned int aligned = 0u;      // lanes whose mask row is 4-byte aligned at `head`
    for (int l = 0; l < nl; ++l)
        if ((reinterpret_cast<uintptr_t>(mask + static_cast<size_t>(l) * n + head) & 3u) == 0)
            aligned |= 1u << l;
    const int4* c4 = reinterpret_cast<const int4*>(codes + head);
    const V* vq = values + head;
    const bool* mh = mask + head;
    const long long chunks = (quads + CHUNK_QUADS - 1) / CHUNK_QUADS;
    // each thread keeps the loads of two chunks in flight while it updates
    // the tables from a third
    ChunkQuads cur, next, after;
    long long k = blockIdx.y;
    cur.load(c4, vq, mh, n, quads, nl, aligned, k * CHUNK_QUADS + threadIdx.x);
    next.load(c4, vq, mh, n, quads, nl, aligned, (k + gridDim.y) * CHUNK_QUADS + threadIdx.x);
    for (; k < chunks; k += gridDim.y) {
        after.load(c4, vq, mh, n, quads, nl, aligned,
                   (k + 2 * gridDim.y) * CHUNK_QUADS + threadIdx.x);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const unsigned int packed = quad_lanes(cur.m[j]);
            const int g[4] = {cur.c[j].x, cur.c[j].y, cur.c[j].z, cur.c[j].w};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                if (static_cast<unsigned int>(g[r]) >= static_cast<unsigned int>(ng)) continue;
                const unsigned int bits = (packed >> (8 * r)) & 0xFFu;
#pragma unroll
                for (int l = 0; l < AGG_LANE_MAX; ++l)
                    if ((bits >> l) & 1u)
                        agg_row(agg_table(smem + l * lane_bytes, ng), ng, g[r], true,
                                cur.v[j][r]);
            }
        }
        cur = next;
        next = after;
    }

    // scalar rows: the head [0, head) and the tail [head + 4 * quads, n)
    const long long tail = head + 4 * quads;
    const long long scalar_rows = head + (n - tail);
    const long long stride = (long long)gridDim.y * AGG_THREADS;
    for (long long i0 = (long long)blockIdx.y * AGG_THREADS + threadIdx.x; i0 < scalar_rows;
         i0 += stride) {
        const long long i = i0 < head ? i0 : tail + (i0 - head);
        const int g = codes[i];
        if (static_cast<unsigned int>(g) >= static_cast<unsigned int>(ng)) continue;
        const float v = static_cast<float>(values[i]);
        for (int l = 0; l < nl; ++l)
            if (mask[static_cast<size_t>(l) * n + i])
                agg_row(agg_table(smem + l * lane_bytes, ng), ng, g, true, v);
    }
    __syncthreads();

    const AggTable w = agg_table(ws, static_cast<size_t>(lanes) * gridDim.y * ng);
    for (int i = threadIdx.x; i < nl * ng; i += AGG_THREADS) {
        const int l = i / ng, g = i - l * ng;
        const AggTable t = agg_table(smem + l * lane_bytes, ng);
        const size_t o = (static_cast<size_t>(first + l) * gridDim.y + blockIdx.y) * ng + g;
        w.sums[o] = t.sums[g];
        w.ext[o] = t.ext[g];
        w.counts[o] = t.counts[g];
    }
}

// ---------------------------------------------------------------------------
// host: launch geometry, cached

std::mutex g_grid_mu;
std::map<std::tuple<const void*, int, size_t>, int> g_grid_cap;  // (kernel, device, smem)
std::map<int, int> g_sms;                                          // device -> SMs

// Blocks that fit on `device` at once (SMs x resident blocks a SM) for
// `kern` with `threads` threads and `smem` bytes of dynamic shared memory;
// `smem_max` is the kernel's largest table, which it is allowed once.
cudaError_t grid_cap(const void* kern, int device, int threads, size_t smem, size_t smem_max,
                     int* cap) {
    std::lock_guard<std::mutex> lock(g_grid_mu);
    const auto key = std::make_tuple(kern, device, smem);
    const auto hit = g_grid_cap.find(key);
    if (hit != g_grid_cap.end()) {
        *cap = hit->second;
        return cudaSuccess;
    }
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem_max));
    if (err != cudaSuccess) return err;
    if (g_sms.find(device) == g_sms.end()) {
        int sms = 0;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        if (err != cudaSuccess) return err;
        g_sms[device] = sms;
    }
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
    if (err != cudaSuccess) return err;
    *cap = g_sms[device] * (per_sm > 0 ? per_sm : 1);
    g_grid_cap.emplace(key, *cap);
    return cudaSuccess;
}

template <int KIND, typename V>
cudaError_t launch_main(int device, const void* codes, const void* values, const void* mask,
                        long long n, int ng, unsigned long long* counts, double* sums,
                        cudaStream_t stream) {
    auto kern = group_agg_kernel<KIND, V>;
    const size_t smem = table_bytes(KIND, ng);
    int cap = 0;
    cudaError_t err = grid_cap(reinterpret_cast<const void*>(kern), device, THREADS, smem,
                               table_bytes(KIND, MAX_GROUPS), &cap);
    if (err != cudaSuccess) return err;
    long long want = (n + THREADS - 1) / THREADS;
    int blocks = static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
    kern<<<blocks, THREADS, smem, stream>>>(
        static_cast<const int*>(codes), static_cast<const V*>(values),
        static_cast<const bool*>(mask), n, ng, counts, sums);
    return cudaGetLastError();
}

// K1/K3 over `lanes` lanes in tiles of `lt`: one wave of blocks, the tiles
// of each row-block side by side.
template <int KIND, typename V>
cudaError_t launch_lanes(int device, const void* codes, const void* values, const void* mask,
                         long long n, int ng, int lanes, int lt, unsigned long long* counts,
                         double* sums, cudaStream_t stream) {
    const size_t smem = lt * lane_table_bytes(KIND, ng);
    if (lt < 1 || lt > LANE_TILE_MAX || smem > LANE_SMEM_MAX) return cudaErrorInvalidValue;
    auto kern = group_agg_lanes_kernel<KIND, V>;
    int cap = 0;
    cudaError_t err = grid_cap(reinterpret_cast<const void*>(kern), device, THREADS, smem,
                               LANE_SMEM_MAX, &cap);
    if (err != cudaSuccess) return err;
    // the quad loop starts at the codes' first 16-byte boundary; values must
    // be aligned at that row too, or every row goes scalar (each lane's mask
    // row is checked in the kernel)
    const uintptr_t pc = reinterpret_cast<uintptr_t>(codes);
    const uintptr_t pv = reinterpret_cast<uintptr_t>(values);
    long long head = static_cast<long long>(((16 - pc % 16) % 16) / sizeof(int));
    if (head > n) head = n;
    const bool aligned = pc % sizeof(int) == 0 &&
                         (KIND == KIND_HIST || (pv + head * sizeof(V)) % 16 == 0);
    long long quads = 0;
    if (aligned) quads = (n - head) / 4;
    else head = n;
    const int tiles = (lanes + lt - 1) / lt;
    const long long want = (n + 4LL * THREADS - 1) / (4LL * THREADS);
    long long rows = cap / tiles;
    if (rows > want) rows = want;
    if (rows < 1) rows = 1;
    kern<<<dim3(tiles, static_cast<unsigned int>(rows)), THREADS, smem, stream>>>(
        static_cast<const int*>(codes), static_cast<const V*>(values),
        static_cast<const bool*>(mask), n, head, quads, ng, lanes, lt, counts, sums);
    return cudaGetLastError();
}

template <typename V>
cudaError_t agg_blocks(int device, long long n, int ng, int* blocks) {
    int cap = 0;
    cudaError_t err = grid_cap(reinterpret_cast<const void*>(&agg_kernel<V>), device, AGG_THREADS,
                               agg_table_bytes(ng), agg_table_bytes(MAX_GROUPS), &cap);
    if (err != cudaSuccess) return err;
    const long long want = (n + 4LL * WARP_QUADS * (AGG_THREADS / 32) - 1) /
                           (4LL * WARP_QUADS * (AGG_THREADS / 32));
    *blocks = static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
    return cudaSuccess;
}

template <typename V>
cudaError_t launch_agg(const void* codes, const void* values, const void* mask, long long n,
                       int ng, int blocks, void* ws, long long* counts, float* out,
                       cudaStream_t stream) {
    // the vector loop starts at the codes' first 16-byte boundary; values and
    // mask must be aligned at that row too, or every row goes scalar
    const uintptr_t pc = reinterpret_cast<uintptr_t>(codes);
    const uintptr_t pv = reinterpret_cast<uintptr_t>(values);
    const uintptr_t pm = reinterpret_cast<uintptr_t>(mask);
    long long head = static_cast<long long>(((16 - pc % 16) % 16) / sizeof(int));
    if (head > n) head = n;
    const bool aligned = pc % sizeof(int) == 0 && (pm + head) % 4 == 0 &&
                         (pv + head * sizeof(V)) % 16 == 0;
    long long quads = 0;
    if (aligned) quads = (n - head) / 4;
    else head = n;
    agg_kernel<V><<<blocks, AGG_THREADS, agg_table_bytes(ng), stream>>>(
        static_cast<const int*>(codes), static_cast<const V*>(values),
        static_cast<const bool*>(mask), n, head, quads, ng, ws);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    agg_merge<<<(ng + MERGE_SLOTS - 1) / MERGE_SLOTS, MERGE_SLOTS * MERGE_WARPS, 0, stream>>>(
        blocks, ng, ws, counts, out);
    return cudaGetLastError();
}

// K2 over `lanes` lanes in tiles of `lt`: the row-blocks of one wave (at
// most one a chunk, at least 1).  Also sets the kernel's shared-memory limit.
template <typename V>
cudaError_t agg_lane_rows(int device, long long n, int ng, int lanes, int lt, int* rows) {
    const size_t smem = lt * agg_lane_table_bytes(ng);
    if (lt < 1 || lt > AGG_LANE_MAX || smem > LANE_SMEM_MAX) return cudaErrorInvalidValue;
    int cap = 0;
    cudaError_t err = grid_cap(reinterpret_cast<const void*>(&agg_lanes_kernel<V>), device,
                               AGG_THREADS, smem, LANE_SMEM_MAX, &cap);
    if (err != cudaSuccess) return err;
    const int tiles = (lanes + lt - 1) / lt;
    const long long chunks = (n / 4 + CHUNK_QUADS - 1) / CHUNK_QUADS;
    long long r = cap / tiles;
    if (r > chunks) r = chunks;
    *rows = static_cast<int>(r < 1 ? 1 : r);
    return cudaSuccess;
}

// K2 over `lanes` lanes in tiles of `lt` over `rows` row-blocks
// (agg_lane_rows), then agg_merge of each lane's `rows` tables.
template <typename V>
cudaError_t launch_agg_lanes(int device, const void* codes, const void* values,
                             const void* mask, long long n, int ng, int lanes, int lt, int rows,
                             void* ws, long long* counts, float* out, cudaStream_t stream) {
    int planned = 0;      // agg_lane_rows checks the tile and sets the shared-memory limit
    cudaError_t err = agg_lane_rows<V>(device, n, ng, lanes, lt, &planned);
    if (err != cudaSuccess) return err;
    // the quad loop starts at the codes' first 16-byte boundary; values must
    // be aligned at that row too, or every row goes scalar (each lane's mask
    // row is checked in the kernel)
    const uintptr_t pc = reinterpret_cast<uintptr_t>(codes);
    const uintptr_t pv = reinterpret_cast<uintptr_t>(values);
    long long head = static_cast<long long>(((16 - pc % 16) % 16) / sizeof(int));
    if (head > n) head = n;
    const bool aligned = pc % sizeof(int) == 0 && (pv + head * sizeof(V)) % 16 == 0;
    long long quads = 0;
    if (aligned) quads = (n - head) / 4;
    else head = n;
    const int tiles = (lanes + lt - 1) / lt;
    agg_lanes_kernel<V><<<dim3(tiles, rows), AGG_THREADS, lt * agg_lane_table_bytes(ng),
                          stream>>>(
        static_cast<const int*>(codes), static_cast<const V*>(values),
        static_cast<const bool*>(mask), n, head, quads, ng, lanes, lt, ws);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    agg_merge<<<dim3((ng + MERGE_SLOTS - 1) / MERGE_SLOTS, lanes), MERGE_SLOTS * MERGE_WARPS, 0,
                stream>>>(rows, ng, ws, counts, out);
    return cudaGetLastError();
}

// K1/K3 over `lanes` mask rows in tiles of `lt` (lanes = 1 and mask one
// row: the one-lane call, lt unused).
int group_agg(int device, int kind, int value_f64, const void* codes, const void* values,
              const void* mask, long long n, int ng, int lanes, int lt, void* ws_counts,
              void* ws_sums, void* out_sums, void* stream_ptr) {
    if (ng < 1 || ng > MAX_GROUPS || n < 0 || lanes < 1 || lanes > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    auto* counts = static_cast<unsigned long long*>(ws_counts);
    auto* sums = static_cast<double*>(ws_sums);
    const int slots = ng * lanes;
    const int small_blocks = (slots + 255) / 256;
    init_workspace<<<small_blocks, 256, 0, stream>>>(kind, slots, counts, sums);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n > 0) {
        const bool one = lt == 0;
        if (kind == KIND_HIST)
            err = one ? launch_main<KIND_HIST, float>(device, codes, values, mask, n, ng, counts,
                                                      sums, stream)
                      : launch_lanes<KIND_HIST, float>(device, codes, values, mask, n, ng,
                                                       lanes, lt, counts, sums, stream);
        else if (kind == KIND_SUM && value_f64)
            err = one ? launch_main<KIND_SUM, double>(device, codes, values, mask, n, ng, counts,
                                                      sums, stream)
                      : launch_lanes<KIND_SUM, double>(device, codes, values, mask, n, ng,
                                                       lanes, lt, counts, sums, stream);
        else if (kind == KIND_SUM)
            err = one ? launch_main<KIND_SUM, float>(device, codes, values, mask, n, ng, counts,
                                                     sums, stream)
                      : launch_lanes<KIND_SUM, float>(device, codes, values, mask, n, ng, lanes,
                                                      lt, counts, sums, stream);
        else
            err = cudaErrorInvalidValue;
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (kind == KIND_HIST) return static_cast<int>(cudaSuccess);
    finalize<<<small_blocks, 256, 0, stream>>>(slots, sums, static_cast<float*>(out_sums));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1/K3.  kind: 0 histogram (K3), 1 count+sum (K1).
// value_f64: values are float64 (else float32); unused for kind 0.
// ws_counts: ng uint64 counts, which are the int64 count output when the
// call returns; ws_sums: ng float64 sums; out_sums: float32[ng].  The sum
// pointers are unused (may be null) for kind 0.
// device: the CUDA device every pointer lies on.
int bk_group_agg(int device, int kind, int value_f64, const void* codes, const void* values,
                 const void* mask, long long n, int ng, void* ws_counts, void* ws_sums,
                 void* out_sums, void* stream_ptr) {
    return group_agg(device, kind, value_f64, codes, values, mask, n, ng, 1, 0, ws_counts,
                     ws_sums, out_sums, stream_ptr);
}

// K1/K3 over `lanes` lanes, `lane_tile` lanes a block (1..LANE_TILE_MAX,
// their tables within 227 KB): mask is [lanes, n], ws_counts [lanes, ng]
// uint64, ws_sums [lanes, ng] float64, out_sums [lanes, ng] float32; codes
// and values are shared by the lanes.
int bk_group_agg_lanes(int device, int kind, int value_f64, const void* codes,
                       const void* values, const void* mask, long long n, int ng, int lanes,
                       int lane_tile, void* ws_counts, void* ws_sums, void* out_sums,
                       void* stream_ptr) {
    if (lane_tile < 1) return static_cast<int>(cudaErrorInvalidValue);
    return group_agg(device, kind, value_f64, codes, values, mask, n, ng, lanes, lane_tile,
                     ws_counts, ws_sums, out_sums, stream_ptr);
}

// One lane's table of group_agg_lanes_kernel in bytes (ops/group_kernels.py
// lane_plan computes the same), the most lanes a block, and the shared
// memory the tile's tables may take.
long long bk_group_agg_lane_table_bytes(int kind, int ng) {
    return static_cast<long long>(lane_table_bytes(kind, ng));
}
int bk_group_agg_lane_tile_max() { return LANE_TILE_MAX; }
long long bk_group_agg_lane_smem_max() { return static_cast<long long>(LANE_SMEM_MAX); }

// K2: the number of blocks bk_fused_agg launches for n rows and ng groups;
// its workspace takes bk_fused_agg_ws_bytes(blocks, ng) bytes.  A value
// <= 0 is minus a cudaError_t.
int bk_fused_agg_blocks(int device, int value_f64, long long n, int ng) {
    if (ng < 1 || ng > MAX_GROUPS || n < 0) return -static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return -static_cast<int>(err);
    int blocks = 0;
    err = value_f64 ? agg_blocks<double>(device, n, ng, &blocks)
                    : agg_blocks<float>(device, n, ng, &blocks);
    return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

long long bk_fused_agg_ws_bytes(int blocks, int ng) {
    return static_cast<long long>(agg_table_bytes(ng)) * blocks;
}

// K2: count + sum + min + max.  ws: 8-byte aligned workspace of
// bk_fused_agg_ws_bytes(blocks, ng) bytes; counts: int64[ng]; out:
// float32[3 * ng] (sums, mins, maxs).
int bk_fused_agg(int device, int value_f64, const void* codes, const void* values,
                 const void* mask, long long n, int ng, int blocks, void* ws, void* counts,
                 void* out, void* stream_ptr) {
    if (ng < 1 || ng > MAX_GROUPS || n < 0 || blocks < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    auto* c = static_cast<long long*>(counts);
    auto* o = static_cast<float*>(out);
    err = value_f64 ? launch_agg<double>(codes, values, mask, n, ng, blocks, ws, c, o, stream)
                    : launch_agg<float>(codes, values, mask, n, ng, blocks, ws, c, o, stream);
    return static_cast<int>(err);
}

// K2 over `lanes` lanes, `lane_tile` lanes a block (1..AGG_LANE_MAX, their
// tables within 227 KB): the row-blocks of its grid; its
// workspace takes bk_fused_agg_ws_bytes(lanes * rows, ng) bytes.  A value <= 0
// is minus a cudaError_t.
int bk_fused_agg_lane_rows(int device, int value_f64, long long n, int ng, int lanes,
                           int lane_tile) {
    if (ng < 1 || ng > MAX_GROUPS || n < 0 || lanes < 1 || lanes > 65535)
        return -static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return -static_cast<int>(err);
    int rows = 0;
    err = value_f64 ? agg_lane_rows<double>(device, n, ng, lanes, lane_tile, &rows)
                    : agg_lane_rows<float>(device, n, ng, lanes, lane_tile, &rows);
    return err == cudaSuccess ? rows : -static_cast<int>(err);
}

// K2 over `lanes` lanes: mask [lanes, n]; `rows` is bk_fused_agg_lane_rows'
// answer; ws takes bk_fused_agg_ws_bytes(lanes * rows, ng) bytes; counts
// int64 [lanes, ng]; out float32 [lanes, 3, ng] (each lane's sums, mins,
// maxs).
int bk_fused_agg_lanes(int device, int value_f64, const void* codes, const void* values,
                       const void* mask, long long n, int ng, int lanes, int lane_tile,
                       int rows, void* ws, void* counts, void* out, void* stream_ptr) {
    if (ng < 1 || ng > MAX_GROUPS || n < 0 || rows < 1 || lanes < 1 || lanes > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    auto* c = static_cast<long long*>(counts);
    auto* o = static_cast<float*>(out);
    err = value_f64 ? launch_agg_lanes<double>(device, codes, values, mask, n, ng, lanes,
                                               lane_tile, rows, ws, c, o, stream)
                    : launch_agg_lanes<float>(device, codes, values, mask, n, ng, lanes,
                                              lane_tile, rows, ws, c, o, stream);
    return static_cast<int>(err);
}

// agg_lanes_kernel's tile (ops/group_kernels.py lane_plan computes the
// same): one lane's table in bytes, and the most lanes a block.
long long bk_fused_agg_lane_table_bytes(int ng) {
    return static_cast<long long>(agg_lane_table_bytes(ng));
}
int bk_fused_agg_lane_max() { return AGG_LANE_MAX; }

}  // extern "C"
