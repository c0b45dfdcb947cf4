// Segment reductions over few segments for Hopper (sm_90a).
//
// Replaces the accelerator branch of baikaldb_tpu/ops/segments.py: seg_sum
// (:50) and _seg_extremum (:69) when _use_onehot holds, where XLA fuses
// where(gid == k, x, identity) into one reduction per segment.  That branch
// is XLA, not Pallas, but it is the TPU's lowering of every dense GROUP BY
// of at most onehot_max_segments slots and of the `present` count under it.
// Contract (the reference's): for a 1-D x and ids gid (int32 or int64), and
// each segment k in [0, S), reduce the rows with gid == k.  Ids outside
// [0, S) drop before any shared or global update.
//   SUM: bool and int32 in uint32, int64 in uint64 (two's complement wrap;
//        a bool sum taken in int64 and cast to int32 gives the same bits),
//        float32 and float64 in float64; out int32 / int64 / the float dtype.
//   MIN/MAX: int32, int64 and bool (as int32) as integers; float32/float64 as
//        order-preserving integer keys (K2's ordered_int), a NaN of either
//        sign entering as the key that wins (INT_MIN for MIN, INT_MAX for
//        MAX: the image of no other float), so a segment holding a NaN gives
//        NaN.  Empty segments hold +inf/-inf or the dtype's max/min.
//
// What bounds it: one read of x and gid per row, n * (itemsize + 4 or 8)
// bytes over the memory rate; the tables stay in shared memory.  The cost
// that can exceed that is the shared-memory update per row, so the table
// layout follows the segment count:
//   PRIVATE (S * THREADS * acc bytes <= PRIVATE_BYTES, e.g. 17 float64
//     slots): each thread owns a column of a slot-major table, t[g * THREADS
//     + tid]; updates are plain read-modify-writes, no atomics and no bank
//     conflicts (a warp's 32 lanes hit 32 consecutive words whatever their
//     ids).  This is the per-thread select+reduce of the TPU's lowering,
//     with the accumulators in shared memory instead of registers.
//   WARP (replica-major, t[r * S + g], r = warp % R): R copies of the table
//     so that the warps of a block do not meet on the same slot; shared
//     atomics (a float64 add is a compare-and-swap loop on sm_90).
//   BLOCK: one copy (R = 1), for large S.
// Each block folds its copies per slot in a fixed order and stores one row
// of a [blocks x S] workspace with plain stores; seg_merge reduces each
// slot's rows in a fixed order and writes the output dtype.  Two launches,
// no init pass, no global atomics.
//
// Lanes (bk_seg_reduce_lanes, seg_lanes_kernel): one launch serves the G
// lanes of a batched-dispatch tick.  x and gid are shared, mask is [G, n] (a
// row drops in lane L where mask[L, i] is false, as an id outside [0, S)
// does), the output is [G, S].  A lane's result must equal, bit for bit, the
// one-lane reduction of (x, where(mask[L], gid, S)): the dispatcher promises
// every client its serial run's float64 sums.  So a lane keeps the one-lane
// plan for (n, S): its rows reach thread t of block b in the one-lane order
// (base = b * span + k * stride, stride from the one-lane block count), each
// lane's table has the one-lane layout and is folded by the same code, and
// seg_merge reduces the lane's rows of the workspace as before.  What the
// lane axis changes is who loads the shared columns: block (tile, b) carries
// a tile of up to LANE_TILE_MAX lanes, with one table each side by side in
// shared memory (tile * table bytes <= 227 KB), loads x and gid of its rows
// once into registers, and updates every lane of the tile from them with the
// lane's mask byte; a thread keeps two steps of loads in flight.  The tiles
// of block b are adjacent in the grid (tile is blockIdx.x), so they run
// together and the later tiles read x and gid from L2.  Device-memory bytes:
// G * n mask bytes + about one read of x and gid, against G * n * (x + id +
// 1) bytes when every lane launched the one-lane grid.  What bounds it on
// the H100: the loads that miss L1 (the mask bytes and ceil(G / tile) reads
// of x and gid, ~2.7 TB/s of them at 64 lanes), then the tables' 8-byte
// read-modify-writes (two shared-memory wavefronts each way a warp).  One
// read of x and gid a thread-block cluster (bulk copies multicast into the
// blocks of a row-block, on mbarriers) measured slower: the cluster's
// per-step handshakes cost more than the L2 reads they save.  The host plan
// of the tile (ops/segments.py lane_plan) is Python, so the CPU tests reach
// it; this side refuses a tile whose tables do not fit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (baikaldb_tpu_torch/ops/group_kernels.py builds it).
// Interface: plain C, loaded with ctypes; pointers are device pointers, the
// stream is PyTorch's current stream; the return value is a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int OP_SUM = 0, OP_MIN = 1, OP_MAX = 2;
constexpr int T_BOOL = 0, T_I32 = 1, T_I64 = 2, T_F32 = 3, T_F64 = 4;
constexpr int MODE_AUTO = 0, MODE_PRIVATE = 1, MODE_WARP = 2, MODE_BLOCK = 3;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;                 // rows a thread keeps in flight
constexpr int MAX_SEGMENTS = 16384;       // a float64 table of 128 KB
constexpr size_t PRIVATE_BYTES = 48 * 1024;
constexpr size_t WARP_BYTES = 64 * 1024;
constexpr size_t SMEM_MAX = 8 * MAX_SEGMENTS;
constexpr int LANE_TILE_MAX = 6;          // lanes one block of seg_lanes_kernel carries
constexpr size_t LANE_SMEM_MAX = 232448;  // 227 KB: one block's shared memory on sm_90
constexpr int MERGE_SLOTS = 32;           // slots of one seg_merge block, one a lane
constexpr int MERGE_WARPS = 16;           // warps of one seg_merge block, splitting the rows

__device__ __forceinline__ int ordered_key(float v) {
    const int i = __float_as_int(v);
    return i >= 0 ? i : i ^ 0x7FFFFFFF;
}
__device__ __forceinline__ long long ordered_key(double v) {
    const long long i = __double_as_longlong(v);
    return i >= 0 ? i : i ^ 0x7FFFFFFFFFFFFFFFLL;
}
__device__ __forceinline__ float from_key(int k) {
    return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}
__device__ __forceinline__ double from_key(long long k) {
    return __longlong_as_double(k >= 0 ? k : k ^ 0x7FFFFFFFFFFFFFFFLL);
}

__device__ __forceinline__ bool ld(const bool* p) {
    return __ldcs(reinterpret_cast<const unsigned char*>(p)) != 0;
}
template <typename T>
__device__ __forceinline__ T ld(const T* p) { return __ldcs(p); }
// the shared columns of the lane kernel: kept in L2 for the block's other tiles
__device__ __forceinline__ bool ld_keep(const bool* p) {
    return __ldg(reinterpret_cast<const unsigned char*>(p)) != 0;
}
template <typename T>
__device__ __forceinline__ T ld_keep(const T* p) { return __ldg(p); }

// Per (op, input type): the accumulator A, its identity, the key of a row,
// how two accumulators combine, and the output type and value.
template <int OP, typename T> struct Red;

template <typename T, typename A, typename O> struct SumInt {
    using Acc = A;
    using Out = O;
    __device__ static A ident() { return A(0); }
    __device__ static A key(T x) { return static_cast<A>(x); }
    __device__ static A combine(A a, A b) { return a + b; }
    __device__ static void shared_update(A* p, A k) { atomicAdd(p, k); }
    __device__ static O out(A a) { return static_cast<O>(a); }
};
template <> struct Red<OP_SUM, bool> : SumInt<bool, unsigned int, int> {};
template <> struct Red<OP_SUM, int> : SumInt<int, unsigned int, int> {};
template <> struct Red<OP_SUM, long long> : SumInt<long long, unsigned long long, long long> {};

template <typename T> struct SumFloat {
    using Acc = double;
    using Out = T;
    __device__ static double ident() { return 0.0; }
    __device__ static double key(T x) { return static_cast<double>(x); }
    __device__ static double combine(double a, double b) { return a + b; }
    __device__ static void shared_update(double* p, double k) { atomicAdd(p, k); }
    __device__ static T out(double a) { return static_cast<T>(a); }
};
template <> struct Red<OP_SUM, float> : SumFloat<float> {};
template <> struct Red<OP_SUM, double> : SumFloat<double> {};

template <bool IS_MIN, typename T, typename A> struct ExtInt {
    using Acc = A;
    using Out = A;
    __device__ static A ident() {
        if constexpr (sizeof(A) == 4) return IS_MIN ? INT_MAX : INT_MIN;
        else return IS_MIN ? LLONG_MAX : LLONG_MIN;
    }
    __device__ static A key(T x) { return static_cast<A>(x); }
    __device__ static A combine(A a, A b) { return IS_MIN ? min(a, b) : max(a, b); }
    __device__ static void shared_update(A* p, A k) {
        if (IS_MIN) atomicMin(p, k); else atomicMax(p, k);
    }
    __device__ static A out(A a) { return a; }
};
template <> struct Red<OP_MIN, bool> : ExtInt<true, bool, int> {};
template <> struct Red<OP_MAX, bool> : ExtInt<false, bool, int> {};
template <> struct Red<OP_MIN, int> : ExtInt<true, int, int> {};
template <> struct Red<OP_MAX, int> : ExtInt<false, int, int> {};
template <> struct Red<OP_MIN, long long> : ExtInt<true, long long, long long> {};
template <> struct Red<OP_MAX, long long> : ExtInt<false, long long, long long> {};

// Floats as ordered integer keys; a NaN is the key that wins.
template <bool IS_MIN, typename T, typename A> struct ExtFloat {
    using Acc = A;
    using Out = T;
    __device__ static constexpr A nan_key() {
        if constexpr (sizeof(A) == 4) return IS_MIN ? INT_MIN : INT_MAX;
        else return IS_MIN ? LLONG_MIN : LLONG_MAX;
    }
    __device__ static A ident() {
        const T inf = static_cast<T>(IS_MIN ? INFINITY : -INFINITY);
        return ordered_key(inf);
    }
    __device__ static A key(T x) { return x != x ? nan_key() : ordered_key(x); }
    __device__ static A combine(A a, A b) { return IS_MIN ? min(a, b) : max(a, b); }
    __device__ static void shared_update(A* p, A k) {
        if (IS_MIN) atomicMin(p, k); else atomicMax(p, k);
    }
    __device__ static T out(A a) {
        return a == nan_key() ? static_cast<T>(NAN) : from_key(a);
    }
};
template <> struct Red<OP_MIN, float> : ExtFloat<true, float, int> {};
template <> struct Red<OP_MAX, float> : ExtFloat<false, float, int> {};
template <> struct Red<OP_MIN, double> : ExtFloat<true, double, long long> {};
template <> struct Red<OP_MAX, double> : ExtFloat<false, double, long long> {};

// Folds a block's table (R copies of S slots) per slot in a fixed order
// into `row`.  PRIVATE: one warp a slot, lanes read consecutive columns, then
// a fixed shuffle tree; else copy 0, then 1, ...  Every thread of the block
// calls it.
template <typename R_, bool PRIVATE>
__device__ __forceinline__ void fold_table(const typename R_::Acc* t, int S, int R,
                                           typename R_::Acc* row) {
    using A = typename R_::Acc;
    if (PRIVATE) {
        const int lane = threadIdx.x & 31;
        for (int g = threadIdx.x >> 5; g < S; g += WARPS) {
            A a = R_::ident();
            for (int k = lane; k < THREADS; k += 32) a = R_::combine(a, t[g * THREADS + k]);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                a = R_::combine(a, __shfl_down_sync(0xFFFFFFFFu, a, off));
            if (lane == 0) row[g] = a;
        }
    } else {
        for (int g = threadIdx.x; g < S; g += THREADS) {
            A a = t[g];
            for (int k = 1; k < R; ++k) a = R_::combine(a, t[static_cast<size_t>(k) * S + g]);
            row[g] = a;
        }
    }
}

// One pass over the rows; block b leaves its table in row b of `ws`.
// PRIVATE: R == THREADS, slot-major table, no atomics; else replica-major.
template <int OP, typename T, typename Id, bool PRIVATE>
__global__ void __launch_bounds__(THREADS)
seg_kernel(const T* __restrict__ x, const Id* __restrict__ gid, long long n, int S, int R,
           typename Red<OP, T>::Acc* __restrict__ ws) {
    using R_ = Red<OP, T>;
    using A = typename R_::Acc;
    extern __shared__ __align__(8) unsigned char smem[];
    A* t = reinterpret_cast<A*>(smem);
    for (int i = threadIdx.x; i < S * R; i += THREADS) t[i] = R_::ident();
    __syncthreads();

    // PRIVATE: this thread's column; else this warp's copy
    A* mine = PRIVATE ? t + threadIdx.x : t + static_cast<size_t>((threadIdx.x >> 5) % R) * S;
    const int pitch = PRIVATE ? THREADS : 1;
    const long long span = (long long)THREADS * UNROLL;
    const long long stride = (long long)gridDim.x * span;
    for (long long base = (long long)blockIdx.x * span + threadIdx.x; base < n; base += stride) {
        Id g[UNROLL];
        T v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long i = base + (long long)u * THREADS;
            if (i < n) {
                g[u] = ld(gid + i);
                v[u] = ld(x + i);
            } else {
                g[u] = -1;
                v[u] = T(0);
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            if (g[u] < 0 || g[u] >= S) continue;     // the drop rule
            A* p = mine + static_cast<size_t>(g[u]) * pitch;
            const A k = R_::key(v[u]);
            if (PRIVATE) *p = R_::combine(*p, k);
            else R_::shared_update(p, k);
        }
    }
    __syncthreads();
    fold_table<R_, PRIVATE>(t, S, R, ws + static_cast<size_t>(blockIdx.x) * S);
}

// The rows one thread holds in one step of the lane kernel: ids, values and
// the mask byte of each row in each lane of the tile, as loaded.  Nothing
// loaded is used here, so every load of a step is in flight at once and the
// next step's loads overlap this step's updates.  Lanes past `nl` read lane
// nl - 1's row again (an L1 hit; they update nothing); rows past n load
// nothing and drop by an id of -1.
template <typename T, typename Id>
struct LaneStep {
    Id g[UNROLL];
    T v[UNROLL];
    unsigned char m[LANE_TILE_MAX][UNROLL];

    __device__ __forceinline__ void load(const T* x, const Id* gid, const bool* mask,
                                         long long n, int nl, long long base) {
        const unsigned char* rows[LANE_TILE_MAX];
#pragma unroll
        for (int l = 0; l < LANE_TILE_MAX; ++l)
            rows[l] = reinterpret_cast<const unsigned char*>(mask) +
                      static_cast<size_t>(min(l, nl - 1)) * n;
        if (base + (long long)(UNROLL - 1) * THREADS < n) {
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const long long i = base + (long long)u * THREADS;
                g[u] = ld_keep(gid + i);
                v[u] = ld_keep(x + i);
#pragma unroll
                for (int l = 0; l < LANE_TILE_MAX; ++l) m[l][u] = __ldcs(rows[l] + i);
            }
            return;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long i = base + (long long)u * THREADS;
            const bool in = i < n;
            g[u] = in ? ld_keep(gid + i) : Id(-1);
            v[u] = in ? ld_keep(x + i) : T(0);
#pragma unroll
            for (int l = 0; l < LANE_TILE_MAX; ++l) m[l][u] = in ? __ldcs(rows[l] + i) : 0;
        }
    }
};

// One step of the lane kernel: `r`'s rows (loaded a step or two before)
// into the tile's tables, after `r` has been handed its next load.  A row's
// update of the tile's lanes reads every lane's slot first, then writes
// them: the tables are disjoint, so the lanes' read-modify-writes overlap
// instead of waiting on each other; each lane still takes its rows in the
// one-lane order.
template <int OP, typename T, typename Id, bool PRIVATE>
__device__ __forceinline__ void lane_step(LaneStep<T, Id>& r, const T* x, const Id* gid,
                                          const bool* mask, long long n, int S, int nl,
                                          long long ahead, typename Red<OP, T>::Acc* mine,
                                          size_t table) {
    using R_ = Red<OP, T>;
    using A = typename R_::Acc;
    Id g[UNROLL];
    T v[UNROLL];
    unsigned int on[LANE_TILE_MAX];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        g[u] = r.g[u];
        v[u] = r.v[u];
    }
#pragma unroll
    for (int l = 0; l < LANE_TILE_MAX; ++l) {
        on[l] = 0u;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            if (l < nl && r.m[l][u] != 0) on[l] |= 1u << u;
    }
    r.load(x, gid, mask, n, nl, ahead);      // its registers are free again
    const int pitch = PRIVATE ? THREADS : 1;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        if (g[u] < 0 || g[u] >= S) continue;     // the drop rule
        A* p = mine + static_cast<size_t>(g[u]) * pitch;
        const A k = R_::key(v[u]);
        if (PRIVATE) {
            A old[LANE_TILE_MAX];
#pragma unroll
            for (int l = 0; l < LANE_TILE_MAX; ++l)
                if ((on[l] >> u) & 1u) old[l] = p[l * table];
#pragma unroll
            for (int l = 0; l < LANE_TILE_MAX; ++l)
                if ((on[l] >> u) & 1u) p[l * table] = R_::combine(old[l], k);
        } else {
#pragma unroll
            for (int l = 0; l < LANE_TILE_MAX; ++l)
                if ((on[l] >> u) & 1u) R_::shared_update(p + l * table, k);
        }
    }
}

// Block (tile, b) of the lane kernel: one-lane block b's rows, in its
// threads' order, for the lanes [tile * lt, min(lanes, (tile + 1) * lt));
// lane L leaves its table in row L * gridDim.y + b of `ws` (seg_merge's
// layout).  Each lane's table is the one-lane table, updated in the one-lane
// order and folded by the one-lane code, so lane L's workspace rows are the
// one-lane kernel's on (x, where(mask[L], gid, S)).  A thread keeps two
// steps of loads in flight (one block an SM fits: the tables take the
// shared memory), so the loads of the step after next overlap this step's
// updates.
template <int OP, typename T, typename Id, bool PRIVATE>
__global__ void __launch_bounds__(THREADS)
seg_lanes_kernel(const T* __restrict__ x, const Id* __restrict__ gid,
                 const bool* __restrict__ mask, long long n, int S, int R, int lanes, int lt,
                 typename Red<OP, T>::Acc* __restrict__ ws) {
    using R_ = Red<OP, T>;
    using A = typename R_::Acc;
    const int first = blockIdx.x * lt;
    const int nl = min(lt, lanes - first);
    const size_t table = static_cast<size_t>(S) * R;
    extern __shared__ __align__(8) unsigned char smem[];
    A* t = reinterpret_cast<A*>(smem);
    for (size_t i = threadIdx.x; i < table * nl; i += THREADS) t[i] = R_::ident();
    __syncthreads();

    A* mine = t + (PRIVATE ? threadIdx.x : static_cast<size_t>((threadIdx.x >> 5) % R) * S);
    const long long span = (long long)THREADS * UNROLL;
    const long long stride = (long long)gridDim.y * span;   // the one-lane block count
    mask += static_cast<size_t>(first) * n;
    LaneStep<T, Id> r0, r1;
    long long base = (long long)blockIdx.y * span + threadIdx.x;
    r0.load(x, gid, mask, n, nl, base);
    r1.load(x, gid, mask, n, nl, base + stride);
    for (; base < n; base += 2 * stride) {
        lane_step<OP, T, Id, PRIVATE>(r0, x, gid, mask, n, S, nl, base + 2 * stride, mine,
                                      table);
        if (base + stride >= n) break;
        lane_step<OP, T, Id, PRIVATE>(r1, x, gid, mask, n, S, nl, base + 3 * stride, mine,
                                      table);
    }
    __syncthreads();
    for (int l = 0; l < nl; ++l)
        fold_table<R_, PRIVATE>(t + l * table, S, R,
                                ws + (static_cast<size_t>(first + l) * gridDim.y + blockIdx.y) * S);
}

// Reduces the `blocks` rows of the workspace per slot in a fixed order and
// writes out[g] in the output dtype; lane blockIdx.y reduces its own
// `blocks` rows into out[blockIdx.y * S ...].
template <int OP, typename T>
__global__ void __launch_bounds__(MERGE_SLOTS * MERGE_WARPS)
seg_merge(int blocks, int S, const typename Red<OP, T>::Acc* __restrict__ ws,
          typename Red<OP, T>::Out* __restrict__ out) {
    using R_ = Red<OP, T>;
    using A = typename R_::Acc;
    ws += static_cast<size_t>(blockIdx.y) * blocks * S;
    out += static_cast<size_t>(blockIdx.y) * S;
    __shared__ A part[MERGE_WARPS][MERGE_SLOTS];
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    const int g = blockIdx.x * MERGE_SLOTS + lane;
    A a = R_::ident();
    if (g < S)
        for (int b = wid; b < blocks; b += MERGE_WARPS)
            a = R_::combine(a, ws[static_cast<size_t>(b) * S + g]);
    part[wid][lane] = a;
    __syncthreads();
    if (wid != 0 || g >= S) return;
    for (int k = 1; k < MERGE_WARPS; ++k) a = R_::combine(a, part[k][lane]);
    out[g] = R_::out(a);
}

// ---------------------------------------------------------------------------
// host: launch plan, cached

struct Plan {
    int blocks;
    int replicas;
    bool priv;
    size_t smem;
};

std::mutex g_mu;
std::map<std::tuple<const void*, int, size_t>, int> g_per_sm;   // (kernel, device, smem)
std::map<int, int> g_sms;                                        // device -> SMs

cudaError_t blocks_per_sm(const void* kern, int device, size_t smem, int* per_sm, int* sms) {
    std::lock_guard<std::mutex> lock(g_mu);
    auto key = std::make_tuple(kern, device, smem);
    auto hit = g_per_sm.find(key);
    if (g_sms.find(device) == g_sms.end()) {
        int s = 0;
        cudaError_t err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, device);
        if (err != cudaSuccess) return err;
        g_sms[device] = s;
    }
    *sms = g_sms[device];
    if (hit != g_per_sm.end()) {
        *per_sm = hit->second;
        return cudaSuccess;
    }
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(SMEM_MAX));
    if (err != cudaSuccess) return err;
    int b = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kern, THREADS, smem);
    if (err != cudaSuccess) return err;
    *per_sm = b > 0 ? b : 1;
    g_per_sm.emplace(key, *per_sm);
    return cudaSuccess;
}

// The table layout for S slots of `slot` bytes (one copy): resolves MODE_AUTO
// by the segment count and gives the copies; false for an unknown mode.
bool table_layout(size_t slot, int* mode, int* replicas) {
    if (*mode == MODE_AUTO)
        *mode = slot * THREADS <= PRIVATE_BYTES ? MODE_PRIVATE
              : slot * 2 <= WARP_BYTES        ? MODE_WARP
                                              : MODE_BLOCK;
    if (*mode == MODE_PRIVATE) {
        *replicas = THREADS;
    } else if (*mode == MODE_WARP) {
        const size_t fit = WARP_BYTES / slot;
        *replicas = fit >= WARPS ? WARPS : (fit > 0 ? static_cast<int>(fit) : 1);
    } else if (*mode == MODE_BLOCK) {
        *replicas = 1;
    } else {
        return false;
    }
    return true;
}

template <int OP, typename T, typename Id>
cudaError_t plan_for(int device, long long n, int S, int mode, Plan* p) {
    using A = typename Red<OP, T>::Acc;
    const size_t slot = sizeof(A) * static_cast<size_t>(S);
    if (!table_layout(slot, &mode, &p->replicas)) return cudaErrorInvalidValue;
    p->priv = mode == MODE_PRIVATE;
    p->smem = slot * p->replicas;
    if (p->smem > SMEM_MAX) return cudaErrorInvalidValue;
    const void* kern = p->priv
        ? reinterpret_cast<const void*>(&seg_kernel<OP, T, Id, true>)
        : reinterpret_cast<const void*>(&seg_kernel<OP, T, Id, false>);
    int per_sm = 0, sms = 0;
    cudaError_t err = blocks_per_sm(kern, device, p->smem, &per_sm, &sms);
    if (err != cudaSuccess) return err;
    const long long want = (n + (long long)THREADS * UNROLL - 1) / ((long long)THREADS * UNROLL);
    const long long cap = (long long)sms * per_sm;
    p->blocks = static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
    return cudaSuccess;
}

// The lane kernels' dynamic-shared-memory attribute, set once a kernel.
std::mutex g_lane_mu;
std::map<const void*, bool> g_lane_attr;

cudaError_t lane_attr(const void* kern) {
    std::lock_guard<std::mutex> lock(g_lane_mu);
    if (g_lane_attr.count(kern)) return cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(LANE_SMEM_MAX));
    if (err == cudaSuccess) g_lane_attr[kern] = true;
    return err;
}

// One reduction over `lanes` lanes in tiles of `lt`; mask is null for the
// one-lane call (lanes = lt = 1).
template <int OP, typename T, typename Id>
cudaError_t run(const void* x, const void* gid, const void* mask, int lanes, int lt,
                long long n, int S, const Plan& p, void* ws, void* out, cudaStream_t stream) {
    using R_ = Red<OP, T>;
    using A = typename R_::Acc;
    auto* w = static_cast<A*>(ws);
    const T* xs = static_cast<const T*>(x);
    const Id* ids = static_cast<const Id*>(gid);
    cudaError_t err;
    if (mask == nullptr) {
        if (p.priv)
            seg_kernel<OP, T, Id, true><<<p.blocks, THREADS, p.smem, stream>>>(
                xs, ids, n, S, p.replicas, w);
        else
            seg_kernel<OP, T, Id, false><<<p.blocks, THREADS, p.smem, stream>>>(
                xs, ids, n, S, p.replicas, w);
    } else {
        // the tile's tables side by side: the host plan must fit them
        if (lt < 1 || lt > LANE_TILE_MAX || static_cast<size_t>(lt) * p.smem > LANE_SMEM_MAX)
            return cudaErrorInvalidValue;
        auto kern = p.priv ? seg_lanes_kernel<OP, T, Id, true> : seg_lanes_kernel<OP, T, Id, false>;
        err = lane_attr(reinterpret_cast<const void*>(kern));
        if (err != cudaSuccess) return err;
        kern<<<dim3((lanes + lt - 1) / lt, p.blocks), THREADS, lt * p.smem, stream>>>(
            xs, ids, static_cast<const bool*>(mask), n, S, p.replicas, lanes, lt, w);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    seg_merge<OP, T><<<dim3((S + MERGE_SLOTS - 1) / MERGE_SLOTS, lanes),
                       MERGE_SLOTS * MERGE_WARPS, 0, stream>>>(
        p.blocks, S, w, static_cast<typename R_::Out*>(out));
    return cudaGetLastError();
}

// Calls F<OP, T, Id>::call(args...) for the runtime codes.
template <template <int, typename, typename> class F, typename... Args>
cudaError_t dispatch(int op, int tcode, int id64, Args... args) {
#define BK_SEG_ID(OPV, TT)                                                    \
    return id64 ? F<OPV, TT, long long>::call(args...) : F<OPV, TT, int>::call(args...)
#define BK_SEG_T(OPV)                                                         \
    switch (tcode) {                                                          \
        case T_BOOL: BK_SEG_ID(OPV, bool);                                    \
        case T_I32: BK_SEG_ID(OPV, int);                                      \
        case T_I64: BK_SEG_ID(OPV, long long);                                \
        case T_F32: BK_SEG_ID(OPV, float);                                    \
        case T_F64: BK_SEG_ID(OPV, double);                                   \
        default: return cudaErrorInvalidValue;                                \
    }
    switch (op) {
        case OP_SUM: BK_SEG_T(OP_SUM);
        case OP_MIN: BK_SEG_T(OP_MIN);
        case OP_MAX: BK_SEG_T(OP_MAX);
        default: return cudaErrorInvalidValue;
    }
#undef BK_SEG_T
#undef BK_SEG_ID
    return cudaErrorInvalidValue;
}

template <int OP, typename T, typename Id> struct PlanF {
    static cudaError_t call(int device, long long n, int S, int mode, Plan* p) {
        return plan_for<OP, T, Id>(device, n, S, mode, p);
    }
};
template <int OP, typename T, typename Id> struct AccBytesF {
    static cudaError_t call(size_t* bytes) {
        *bytes = sizeof(typename Red<OP, T>::Acc);
        return cudaSuccess;
    }
};
template <int OP, typename T, typename Id> struct RunF {
    static cudaError_t call(const void* x, const void* gid, const void* mask, int lanes,
                            int lt, long long n, int S, Plan p, void* ws, void* out,
                            cudaStream_t stream) {
        return run<OP, T, Id>(x, gid, mask, lanes, lt, n, S, p, ws, out, stream);
    }
};

}  // namespace

extern "C" {

// The launch plan for n rows into S segments: the number of blocks (> 0), or
// minus a cudaError_t.  op: 0 sum, 1 min, 2 max; tcode: 0 bool, 1 int32,
// 2 int64, 3 float32, 4 float64; id64: ids are int64 (else int32); mode:
// 0 chooses the table layout by S, 1 private, 2 per warp, 3 one per block.
// The workspace takes bk_seg_ws_bytes(op, tcode, blocks, S) bytes.
int bk_seg_blocks(int device, int op, int tcode, int id64, long long n, int S, int mode) {
    if (S < 1 || S > MAX_SEGMENTS || n < 0) return -static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return -static_cast<int>(err);
    Plan p{};
    err = dispatch<PlanF>(op, tcode, id64, device, n, S, mode, &p);
    return err == cudaSuccess ? p.blocks : -static_cast<int>(err);
}

long long bk_seg_ws_bytes(int op, int tcode, int blocks, int S) {
    size_t acc = 0;
    if (dispatch<AccBytesF>(op, tcode, 0, &acc) != cudaSuccess) return -1;
    return static_cast<long long>(acc) * blocks * S;
}

int bk_seg_max_segments() { return MAX_SEGMENTS; }

// One reduction: x [n] of tcode, gid [n] int32/int64, ws 8-byte aligned of
// bk_seg_ws_bytes bytes, out [S] of the output dtype; `blocks` and `mode`
// as bk_seg_blocks gave and took them.
int bk_seg_reduce_lanes(int device, int op, int tcode, int id64, const void* x,
                        const void* gid, const void* mask, int lanes, int lane_tile,
                        long long n, int S, int mode, int blocks, void* ws, void* out,
                        void* stream_ptr);

int bk_seg_reduce(int device, int op, int tcode, int id64, const void* x, const void* gid,
                  long long n, int S, int mode, int blocks, void* ws, void* out,
                  void* stream_ptr) {
    return bk_seg_reduce_lanes(device, op, tcode, id64, x, gid, nullptr, 1, 1, n, S, mode,
                               blocks, ws, out, stream_ptr);
}

// The reduction over `lanes` lanes: x [n] and gid [n] shared, mask bool
// [lanes, n], ws of lanes * bk_seg_ws_bytes bytes, out [lanes, S]; `blocks`
// and `mode` as bk_seg_blocks gave and took them for ONE lane; `lane_tile`
// lanes a block (1..bk_seg_lane_tile_max(), their tables within 227 KB).
int bk_seg_reduce_lanes(int device, int op, int tcode, int id64, const void* x,
                        const void* gid, const void* mask, int lanes, int lane_tile,
                        long long n, int S, int mode, int blocks, void* ws, void* out,
                        void* stream_ptr) {
    if (S < 1 || S > MAX_SEGMENTS || n < 0 || blocks < 1 || lanes < 1 || lanes > 65535 ||
        (mask == nullptr && (lanes != 1 || lane_tile != 1)))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    Plan p{};
    err = dispatch<PlanF>(op, tcode, id64, device, n, S, mode, &p);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (p.blocks != blocks) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(dispatch<RunF>(op, tcode, id64, x, gid, mask, lanes, lane_tile, n,
                                           S, p, ws, out,
                                           static_cast<cudaStream_t>(stream_ptr)));
}

// The shared-memory bytes of one lane's table (the one-lane kernel's) for
// (op, tcode, S, mode), or minus a cudaError_t: ops/segments.py lane_plan
// computes the same and is checked against it.
long long bk_seg_table_bytes(int op, int tcode, int S, int mode) {
    if (S < 1 || S > MAX_SEGMENTS) return -static_cast<long long>(cudaErrorInvalidValue);
    size_t acc = 0;
    if (dispatch<AccBytesF>(op, tcode, 0, &acc) != cudaSuccess)
        return -static_cast<long long>(cudaErrorInvalidValue);
    int replicas = 0;
    if (!table_layout(acc * S, &mode, &replicas))
        return -static_cast<long long>(cudaErrorInvalidValue);
    return static_cast<long long>(acc * S * replicas);
}

int bk_seg_lane_tile_max() { return LANE_TILE_MAX; }
long long bk_seg_lane_smem_max() { return static_cast<long long>(LANE_SMEM_MAX); }

}  // extern "C"
