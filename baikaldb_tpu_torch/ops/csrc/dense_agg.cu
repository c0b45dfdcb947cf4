// The wide dense GROUP BY for Hopper (sm_90a): every aggregate of one GROUP
// BY in one pass over the rows.
//
// Replaces no TPU kernel.  The JAX package leaves a dense GROUP BY above
// ONEHOT_MAX_SEGMENTS slots to XLA's scatter (baikaldb_tpu/ops/segments.py
// seg_sum :50 and _seg_extremum :69 off the one-hot branch), and the port ran
// PyTorch's library scatter there (ops/hashagg.py _segment_one): one
// index_add_ or scatter_reduce_ pass over every row per aggregate, one int32
// live count per aggregate and one for `present`, each pass sending every
// dead row to a single drop slot, so that on a filtered batch nearly every
// atomic of the pass lands on one address.  This kernel is the route of
// ops/hashagg.py dense_route "wide": a CUDA batch, more slots than the
// segment kernel's gate, K1-K3 declined, COUNT(*)/COUNT/SUM/AVG/MIN/MAX
// without DISTINCT over int32, int64, float32 or float64 columns.
//
// Contract: gid int32[n] (a slot outside [0, ng) drops), sel bool[n] or null
// (every row live).  cnt int32[ng] counts the live rows of each slot.  Each
// accumulator (at most MAX_ACCS) takes the live rows whose column is valid
// (valid null: the column has no NULLs):
//   COUNT    int32[ng], +1 a row
//   FLAG     uint8[ng], set to 1 (the non-empty mark of a nullable column)
//   SUM_I64  int64 from int32/int64 values, two's complement wrap
//   SUM_F64  float64 from any of the four value types, float64 atomics (the
//            order, and so the last bits, change from run to run)
//   MIN/MAX  in the value's dtype: integers by the native atomics; floats as
//            their raw bits, a clear sign bit through the signed atomic and
//            a set one through the unsigned opposite, which orders every
//            float but NaN; a NaN enters as the pattern that wins both paths
//            (all ones for MIN, 0x7F..F for MAX), so a slot holding a NaN of
//            either sign gives NaN, as the scatter's amin/amax do.
// The caller fills every output beforehand (zeros; MIN/MAX the dtype's max
// or min, +inf/-inf for floats), so an empty slot keeps that identity.
//
// What bounds it: one read of gid (4 B) and sel (1 B) a row, and for the live
// rows only the value and validity of each column and the atomics of the
// slots they hit: n * 5 bytes over the memory rate when few rows are live.
// Design: lane l of a warp takes row base + 32u + l for u < UNROLL, the
// loads of all UNROLL rows issued before any is used (128-byte coalesced
// warp loads, four rows in flight a thread).  A window of 32 rows whose
// ballot holds no live row costs nothing more, and a dead row never touches
// a slot: there is no drop slot.  Rows of one window with equal slots merge
// before the atomics: __match_any_sync on the slot gives each live lane its
// peers, a shuffle tree over the peers (log2 of the largest run, skipped
// when no slot repeats) folds each accumulator into the lowest peer, which
// alone issues the atomics (lineitem arrives in order-key order, ~4 rows a
// key).  The accumulators' plan rides in the kernel's parameter space
// (__grid_constant__), read warp-uniformly, so every branch on it is taken
// by whole warps.  A live row loads each column after the previous
// accumulator's atomics: issuing all of a window's loads first (eight
// accumulators at a time) spilled registers and took q10's shape from
// 0.116 to 0.338 device ms (PERF.md, section 6).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (baikaldb_tpu_torch/ops/group_kernels.py build_all).
// Interface: plain C, loaded with ctypes; pointers are device pointers, the
// stream is PyTorch's current stream; the return value is a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <map>
#include <mutex>

namespace {

constexpr int MAX_ACCS = 32;
constexpr int THREADS = 256;
constexpr int UNROLL = 4;                  // windows of 32 rows a warp loads at once
constexpr int CHUNK = 32 * UNROLL;         // rows a warp takes a step
constexpr unsigned FULL = 0xFFFFFFFFu;

enum Kind { ACC_COUNT = 0, ACC_FLAG = 1, ACC_SUM_I64 = 2, ACC_SUM_F64 = 3, ACC_MIN = 4,
            ACC_MAX = 5 };
enum VType { I32 = 1, I64 = 2, F32 = 3, F64 = 4 };

struct Acc {
    void* out;
    const void* val;
    const unsigned char* valid;   // null: no NULLs in the column
    int kind;
    int vtype;
};

struct Plan {
    const int* gid;
    const unsigned char* sel;     // null: every row live
    int* cnt;
    long long n;
    int ng;
    int n_accs;
    Acc accs[MAX_ACCS];
};

// the fold of `x` over the live lanes of `peers` into the lowest of them
// (a tree over the peers, one shuffle a level); `merge` is warp-uniform and
// false when no slot of the window repeats
template <class T, class F>
__device__ __forceinline__ T fold_peers(unsigned peers, T x, bool merge, F op) {
    if (!merge) return x;
    const int lane = threadIdx.x & 31;
    int rank = __popc(peers & ((1u << lane) - 1u));
    unsigned rest = peers & (0xFFFFFFFEu << lane);
    while (__any_sync(FULL, rest != 0u)) {
        const int next = __ffs(rest);
        const T t = __shfl_sync(FULL, x, next ? next - 1 : lane);
        if (next) x = op(x, t);
        rest &= ~__ballot_sync(FULL, rank & 1);
        rank >>= 1;
    }
    return x;
}

template <class V> struct Lim;
template <> struct Lim<int> {
    __device__ static int least() { return INT_MIN; }
    __device__ static int most() { return INT_MAX; }
};
template <> struct Lim<long long> {
    __device__ static long long least() { return LLONG_MIN; }
    __device__ static long long most() { return LLONG_MAX; }
};
template <class V> __device__ __forceinline__ V infinity();
template <> __device__ __forceinline__ float infinity<float>() { return __int_as_float(0x7F800000); }
template <> __device__ __forceinline__ double infinity<double>() {
    return __longlong_as_double(0x7FF0000000000000ll);
}

template <class T> __device__ __forceinline__ T lo(T a, T b) { return b < a ? b : a; }
template <class T> __device__ __forceinline__ T hi(T a, T b) { return a < b ? b : a; }
// float MIN/MAX that keep a NaN
template <class T> __device__ __forceinline__ T lo_nan(T a, T b) {
    return a != a ? a : b != b ? b : lo(a, b);
}
template <class T> __device__ __forceinline__ T hi_nan(T a, T b) {
    return a != a ? a : b != b ? b : hi(a, b);
}

__device__ __forceinline__ void atomic_lo(int* p, int v) { atomicMin(p, v); }
__device__ __forceinline__ void atomic_hi(int* p, int v) { atomicMax(p, v); }
__device__ __forceinline__ void atomic_lo(long long* p, long long v) { atomicMin(p, v); }
__device__ __forceinline__ void atomic_hi(long long* p, long long v) { atomicMax(p, v); }

__device__ __forceinline__ void atomic_lo(float* p, float v) {
    if (v != v) {
        atomicMax(reinterpret_cast<unsigned int*>(p), 0xFFFFFFFFu);
        return;
    }
    const int b = __float_as_int(v);
    if (b >= 0) atomicMin(reinterpret_cast<int*>(p), b);
    else atomicMax(reinterpret_cast<unsigned int*>(p), static_cast<unsigned int>(b));
}

__device__ __forceinline__ void atomic_hi(float* p, float v) {
    if (v != v) {
        atomicMax(reinterpret_cast<int*>(p), 0x7FFFFFFF);
        return;
    }
    const int b = __float_as_int(v);
    if (b >= 0) atomicMax(reinterpret_cast<int*>(p), b);
    else atomicMin(reinterpret_cast<unsigned int*>(p), static_cast<unsigned int>(b));
}

__device__ __forceinline__ void atomic_lo(double* p, double v) {
    if (v != v) {
        atomicMax(reinterpret_cast<unsigned long long*>(p), 0xFFFFFFFFFFFFFFFFull);
        return;
    }
    const long long b = __double_as_longlong(v);
    if (b >= 0) atomicMin(reinterpret_cast<long long*>(p), b);
    else atomicMax(reinterpret_cast<unsigned long long*>(p), static_cast<unsigned long long>(b));
}

__device__ __forceinline__ void atomic_hi(double* p, double v) {
    if (v != v) {
        atomicMax(reinterpret_cast<long long*>(p), 0x7FFFFFFFFFFFFFFFll);
        return;
    }
    const long long b = __double_as_longlong(v);
    if (b >= 0) atomicMax(reinterpret_cast<long long*>(p), b);
    else atomicMin(reinterpret_cast<unsigned long long*>(p), static_cast<unsigned long long>(b));
}

template <class V>
__device__ __forceinline__ V value(const Acc& a, long long row, bool ok, V ident) {
    return ok ? __ldg(static_cast<const V*>(a.val) + row) : ident;
}

template <class V>
__device__ __forceinline__ void sum_i64(const Acc& a, long long row, int slot, bool ok,
                                        unsigned peers, bool lead, bool merge) {
    const unsigned long long x = static_cast<unsigned long long>(
        static_cast<long long>(value<V>(a, row, ok, V(0))));
    const unsigned long long s = fold_peers(
        peers, x, merge, [](unsigned long long p, unsigned long long q) { return p + q; });
    if (lead) atomicAdd(static_cast<unsigned long long*>(a.out) + slot, s);
}

template <class V>
__device__ __forceinline__ void sum_f64(const Acc& a, long long row, int slot, bool ok,
                                        unsigned peers, bool lead, bool merge) {
    const double x = static_cast<double>(value<V>(a, row, ok, V(0)));
    const double s = fold_peers(peers, x, merge, [](double p, double q) { return p + q; });
    if (lead) atomicAdd(static_cast<double*>(a.out) + slot, s);
}

template <class V, bool IS_MIN>
__device__ __forceinline__ void extremum_int(const Acc& a, long long row, int slot, bool ok,
                                             unsigned peers, bool lead, bool merge) {
    const V x = value<V>(a, row, ok, IS_MIN ? Lim<V>::most() : Lim<V>::least());
    const V m = IS_MIN ? fold_peers(peers, x, merge, [](V p, V q) { return lo(p, q); })
                       : fold_peers(peers, x, merge, [](V p, V q) { return hi(p, q); });
    if (!lead) return;
    if (IS_MIN) atomic_lo(static_cast<V*>(a.out) + slot, m);
    else atomic_hi(static_cast<V*>(a.out) + slot, m);
}

template <class V, bool IS_MIN>
__device__ __forceinline__ void extremum_float(const Acc& a, long long row, int slot, bool ok,
                                               unsigned peers, bool lead, bool merge) {
    const V inf = infinity<V>();
    const V x = value<V>(a, row, ok, IS_MIN ? inf : -inf);
    const V m = IS_MIN ? fold_peers(peers, x, merge, [](V p, V q) { return lo_nan(p, q); })
                       : fold_peers(peers, x, merge, [](V p, V q) { return hi_nan(p, q); });
    if (!lead) return;
    if (IS_MIN) atomic_lo(static_cast<V*>(a.out) + slot, m);
    else atomic_hi(static_cast<V*>(a.out) + slot, m);
}

template <bool IS_MIN>
__device__ __forceinline__ void extremum(const Acc& a, long long row, int slot, bool ok,
                                         unsigned peers, bool lead, bool merge) {
    switch (a.vtype) {
        case I32: extremum_int<int, IS_MIN>(a, row, slot, ok, peers, lead, merge); break;
        case I64: extremum_int<long long, IS_MIN>(a, row, slot, ok, peers, lead, merge); break;
        case F32: extremum_float<float, IS_MIN>(a, row, slot, ok, peers, lead, merge); break;
        default: extremum_float<double, IS_MIN>(a, row, slot, ok, peers, lead, merge); break;
    }
}

// one window of 32 rows, one a lane; `live` holds only for a live row whose
// slot lies in [0, ng)
__device__ __forceinline__ void window(const Plan& p, long long row, int slot, bool live) {
    const unsigned live_mask = __ballot_sync(FULL, live);
    if (live_mask == 0u) return;
    const int lane = threadIdx.x & 31;
    const unsigned peers = __match_any_sync(FULL, live ? slot : -1) & live_mask;
    const bool leader = live && __ffs(peers) - 1 == lane;
    const bool merge = __any_sync(FULL, (peers & (peers - 1u)) != 0u);
    if (leader) atomicAdd(p.cnt + slot, __popc(peers));
    for (int i = 0; i < p.n_accs; ++i) {
        const Acc& a = p.accs[i];
        const bool ok = live && (a.valid == nullptr || __ldg(a.valid + row) != 0);
        const unsigned oks = __ballot_sync(FULL, ok) & peers;
        const bool lead = leader && oks != 0u;
        switch (a.kind) {
            case ACC_COUNT:
                if (lead) atomicAdd(static_cast<int*>(a.out) + slot, __popc(oks));
                break;
            case ACC_FLAG:
                if (lead) static_cast<unsigned char*>(a.out)[slot] = 1;
                break;
            case ACC_SUM_I64:
                if (a.vtype == I32) sum_i64<int>(a, row, slot, ok, peers, lead, merge);
                else sum_i64<long long>(a, row, slot, ok, peers, lead, merge);
                break;
            case ACC_SUM_F64:
                switch (a.vtype) {
                    case I32: sum_f64<int>(a, row, slot, ok, peers, lead, merge); break;
                    case I64: sum_f64<long long>(a, row, slot, ok, peers, lead, merge); break;
                    case F32: sum_f64<float>(a, row, slot, ok, peers, lead, merge); break;
                    default: sum_f64<double>(a, row, slot, ok, peers, lead, merge); break;
                }
                break;
            case ACC_MIN: extremum<true>(a, row, slot, ok, peers, lead, merge); break;
            default: extremum<false>(a, row, slot, ok, peers, lead, merge); break;
        }
    }
}

__global__ void __launch_bounds__(THREADS) dense_agg_kernel(const __grid_constant__ Plan p) {
    const int lane = threadIdx.x & 31;
    const long long warp = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
    const long long step = (static_cast<long long>(gridDim.x) * THREADS >> 5) * CHUNK;
    for (long long base = warp * CHUNK; base < p.n; base += step) {
        int slot[UNROLL];
        bool live[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long row = base + 32 * u + lane;
            const bool in = row < p.n;
            slot[u] = in ? __ldg(p.gid + row) : -1;
            live[u] = in && (p.sel == nullptr || __ldg(p.sel + row) != 0);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            window(p, base + 32 * u + lane, slot[u],
                   live[u] && static_cast<unsigned>(slot[u]) < static_cast<unsigned>(p.ng));
    }
}

// ---------------------------------------------------------------------------
// host: the grid, cached per device

std::mutex g_mu;
std::map<int, int> g_grid;   // device -> resident blocks (SMs x blocks a SM)

cudaError_t grid_cap(int device, int* cap) {
    std::lock_guard<std::mutex> lock(g_mu);
    const auto hit = g_grid.find(device);
    if (hit != g_grid.end()) {
        *cap = hit->second;
        return cudaSuccess;
    }
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dense_agg_kernel, THREADS, 0);
    if (err != cudaSuccess) return err;
    *cap = g_grid[device] = sms * (per_sm > 0 ? per_sm : 1);
    return cudaSuccess;
}

bool valid_acc(int kind, int vtype) {
    if (kind == ACC_COUNT || kind == ACC_FLAG) return true;
    if (vtype < I32 || vtype > F64) return false;
    if (kind == ACC_SUM_I64) return vtype == I32 || vtype == I64;
    return kind == ACC_SUM_F64 || kind == ACC_MIN || kind == ACC_MAX;
}

}  // namespace

extern "C" {

int bk_dense_agg_max_accs() { return MAX_ACCS; }

// One GROUP BY: gid int32[n], sel bool[n] or null, cnt int32[ng]; n_accs
// accumulators, the i-th of kind kinds[i] over the values vals[i] (vtypes[i]:
// 1 int32, 2 int64, 3 float32, 4 float64; unused by COUNT and FLAG) with the
// validity valids[i] (bool[n] or null) into outs[i] [ng].  Every output is
// filled by the caller beforehand.
int bk_dense_agg(int device, const void* gid, const void* sel, long long n, int ng, void* cnt,
                 int n_accs, const int* kinds, const int* vtypes, void* const* outs,
                 const void* const* vals, const void* const* valids, void* stream_ptr) {
    if (n < 0 || ng < 1 || n_accs < 0 || n_accs > MAX_ACCS)
        return static_cast<int>(cudaErrorInvalidValue);
    Plan p{};
    p.gid = static_cast<const int*>(gid);
    p.sel = static_cast<const unsigned char*>(sel);
    p.cnt = static_cast<int*>(cnt);
    p.n = n;
    p.ng = ng;
    p.n_accs = n_accs;
    for (int i = 0; i < n_accs; ++i) {
        // an empty tensor's data pointer is null: only rows need values
        if (!valid_acc(kinds[i], vtypes[i]) || outs[i] == nullptr
            || (n > 0 && kinds[i] > ACC_FLAG && vals[i] == nullptr))
            return static_cast<int>(cudaErrorInvalidValue);
        p.accs[i] = Acc{outs[i], vals[i], static_cast<const unsigned char*>(valids[i]),
                        kinds[i], vtypes[i]};
    }
    if (n == 0) return static_cast<int>(cudaSuccess);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    int cap = 0;
    err = grid_cap(device, &cap);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long rows_per_block = static_cast<long long>(THREADS / 32) * CHUNK;
    const long long need = (n + rows_per_block - 1) / rows_per_block;
    const int blocks = static_cast<int>(need < cap ? need : cap);
    dense_agg_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream_ptr)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
