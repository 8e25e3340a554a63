// The backward of a row gather, and the edge segment sum: the cotangents
// of each id summed into its row of a (V, D) table, by sort and segment,
// with no float atomics.
//
// Replaces the scatter-add backward of oovrec_tpu/ops/embed_grad.py:
// gather_rows (:90) and packed_gather (:161), and jax.ops.segment_sum of
// the graph models. Those are JAX custom-VJP gathers and an XLA scatter,
// not Pallas kernels; their TPU backward is a one-hot matmul or XLA's
// serialised scatter-add. On the card the trouble is duplicates:
// branchless routing gathers the placeholder bucket 0 for every IV row, a
// small-vocabulary token field repeats a few rows a whole batch long, and
// a graph's destination rows take thousands of edges each.
//
// Contract: g (n, D) f32 row-major, ids (n,) int32 or int64 in [0, V),
// live (n,) uint8 or null; out (V, D) f32. out[r] = the sum of g[i] over
// the positions i with ids[i] == r and live[i] != 0. A row that is not
// live adds nothing (routing throws it away; its cotangent is zero).
//
// What bounds it on an H100: bytes. g is read once, the ids once, out
// written once: 0.7 us at 8,192 x 64 into 1,024 rows, 126 us for 1.6 M
// edges x 64 into 9,748 rows at 3.35 TB/s. The earlier design lost to
// what surrounds the sum: about seven launches a call (a memset of the
// table, key making, a device-wide radix sort of several passes, two
// segment kernels), fixed edges sorted again on every call, and one
// scalar load a thread. This design:
//
//   1. A plan for indices that never change (a graph's edges): the
//      stable order of the positions by id, the sorted keys, the row
//      offsets (V + 1) and, for each chunk of the sorted positions, the
//      chunks of the run it begins inside and of the run it ends inside
//      (`spans`, the split of heavy rows into fixed chunks). Built once
//      (`embed_grad_sort` with spans and offsets), it turns a call into
//      one launch: `segment_pass` alone, which also writes every empty
//      row's zeros, so no memset.
//   2. Ids that change with each call: at n <= BLOCK_MAX one block makes
//      the keys and sorts them stably in shared memory (`sort_block`,
//      cub's BlockRadixSort over the bits in which the call's smallest and
//      largest keys differ) and writes the same arrays, then
//      `segment_pass`: two launches, three with the memset that stays
//      where V > n (the dense table's write is then the bound). One SM's
//      radix passes bound this sort, not bytes; its loads and stores are
//      coalesced through shared memory. Larger n keeps the device-wide
//      sort (`make_keys`, cub::DeviceRadixSort over the bits V needs), a
//      memset and `segment_pass`, which then finds each chunk's crossing
//      runs itself by binary search. The caller chooses the route; up to
//      BLOCK_MAX the one block was the faster on the card at every shape
//      timed (PERF.md §6). A plan of few ids into more rows than the
//      block's shared memory holds offsets for takes them from
//      `plan_tables`.
//   3. `segment_pass`: a group of L lanes (L the power of two that covers
//      a row's 16-byte vectors, or its floats where D % 4 != 0 or a
//      pointer is not 16-byte aligned, at most 32) walks one chunk of
//      sorted positions over one slice of SLICE_FLOATS columns (a wider
//      row, RippleNet's 4,096-wide relation rows, takes several groups a
//      chunk), UNROLL rows in flight a lane, each lane summing its
//      columns in sorted order and writing a run's sum where the key
//      changes. A run inside a chunk goes to out; the piece of a run that
//      crosses a chunk edge goes to its chunk's head or tail slot, and the
//      last of the run's chunks to finish (an integer atomic counter on
//      the run's first chunk, one a slice, reset by that last one) adds
//      the pieces in chunk order and writes out.
//
// Every element is summed in one fixed order for given inputs (sorted
// order inside a chunk, then chunk order), so a repeat run and a graph
// replay give the same bits; integer-valued cotangents give the plain
// version's bits. What still bounds it: with a plan, bytes (the pass
// reads the rows in sorted order, near the byte bound at 1.6 M edges);
// for a batch of ids, the one-block sort's passes and the pass's chain of
// dependent loads, a few microseconds each (PERF.md §6, row 7).

#include <algorithm>
#include <cub/cub.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PASS_THREADS = 128;  // threads of a `segment_pass` block
constexpr int UNROLL = 8;          // rows a lane has in flight
constexpr int ZERO_ROWS = 64;      // rows a group checks for emptiness, at most, past the chunks
constexpr int SLICE_FLOATS = 512;  // columns of a row one group walks: wider rows take slices
constexpr int BLOCK_MAX = 16384;   // positions `sort_block` sorts in one block, at most
constexpr int RADIX_BITS = 5;      // its digits: 10-bit keys in two passes (a 1,024-row table)

__device__ __forceinline__ int lower_bound(const unsigned int* k, int n, unsigned int key) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (k[mid] < key) lo = mid + 1; else hi = mid;
    }
    return lo;
}

__device__ __forceinline__ int upper_bound(const unsigned int* k, int n, unsigned int key) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (k[mid] <= key) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// The crossing runs of chunk c of the sorted keys: x, the first chunk of
// the run the chunk begins inside (-1: the chunk begins a run); y, the
// last chunk of the run its last live position goes on into (-1: that run
// ends in the chunk). Dead keys (key == dead) make no run.
__device__ __forceinline__ int2 chunk_span(const unsigned int* sk, int n, int c, int chunk,
                                           unsigned int dead) {
    const int s = c * chunk;
    const int e = min(s + chunk, n);
    int2 out = make_int2(-1, -1);
    const unsigned int kf = sk[s];
    if (kf != dead && s > 0 && sk[s - 1] == kf) out.x = lower_bound(sk, n, kf) / chunk;
    const unsigned int kl = sk[e - 1];
    if (kl != dead && e < n && sk[e] == kl) out.y = (upper_bound(sk, n, kl) - 1) / chunk;
    return out;
}

__host__ __device__ constexpr int log2_of(int v) { return v <= 1 ? 0 : 1 + log2_of(v / 2); }

__device__ __forceinline__ float vzero(float) { return 0.f; }
__device__ __forceinline__ float4 vzero(float4) { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The pieces of a crossing run, in chunk order, added by the last of its
// chunks to finish: tail[c0], then head[c0 + 1 .. c1], over the columns
// [col0, col1) of the group's slice (`cnt`: the slice's counters). The
// writers' fence before the counter makes their pieces visible to that
// last group.
template <typename T>
__device__ __forceinline__ void finish_run(int c0, int c1, unsigned int key, int ncols, int col0,
                                           int col1, int lane, int L, unsigned int gmask,
                                           int* cnt, const T* head, const T* tail,
                                           T* __restrict__ out) {
    __threadfence();
    __syncwarp(gmask);
    int last = 0;
    if (lane == 0) last = atomicAdd(cnt + c0, 1) == c1 - c0;
    last = __shfl_sync(gmask, last, 0, L);
    if (!last) return;
    __threadfence();
    for (int col = col0 + lane; col < col1; col += L) {
        T acc = __ldcg(tail + (size_t)c0 * ncols + col);
#pragma unroll 8
        for (int k = c0 + 1; k <= c1; ++k) acc = vadd(acc, __ldcg(head + (size_t)k * ncols + col));
        out[(size_t)key * ncols + col] = acc;
    }
    if (lane == 0) cnt[c0] = 0;  // ready for the next call
}

// One chunk of sorted positions [c * chunk, ..) walked by a group of L
// lanes over the columns [col0, col1) of its slice, each lane its columns
// col = col0 + lane, col0 + lane + L, ...
template <typename T>
__device__ __forceinline__ void walk_chunk(int c, const T* __restrict__ g,
                                           const int* __restrict__ perm,
                                           const unsigned int* __restrict__ sk,
                                           const int2* __restrict__ spans, int* cnt, T* head,
                                           T* tail, T* __restrict__ out, int n, int ncols,
                                           int col0, int col1, unsigned int dead, int chunk,
                                           int lane, int L, unsigned int gmask) {
    const int s = c * chunk;
    const int e = min(s + chunk, n);
    // what the walk starts from, loaded together; the next UNROLL keys and
    // positions then load while this UNROLL's rows do
    const int2 given = spans != nullptr ? spans[c] : make_int2(-1, -1);
    const unsigned int kf = sk[s], kl = sk[e - 1];
    unsigned int kn[UNROLL];
    int rn[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        kn[u] = s + u < e ? sk[s + u] : dead;
        rn[u] = s + u < e ? perm[s + u] : 0;
    }
    if (kf == dead) return;  // the discarded rows sort last
    const int2 sp = spans != nullptr ? given : chunk_span(sk, n, c, chunk, dead);
    const bool whole = sp.x >= 0 && sp.y >= 0 && kf == kl;  // the chunk lies inside one run
    for (int col = col0 + lane; col < col1; col += L) {
        T acc = vzero(T());
        unsigned int key = kf;
        bool first = true;  // the chunk's first piece
        if (col != col0 + lane) {  // a later column pass starts over
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                kn[u] = s + u < e ? sk[s + u] : dead;
                rn[u] = s + u < e ? perm[s + u] : 0;
            }
        }
        for (int p0 = s; p0 < e; p0 += UNROLL) {
            unsigned int k[UNROLL];
            T v[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                k[u] = kn[u];
                v[u] = k[u] != dead ? __ldg(g + (size_t)rn[u] * ncols + col) : vzero(T());
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const int p = p0 + UNROLL + u;
                kn[u] = p < e ? sk[p] : dead;
                rn[u] = p < e ? perm[p] : 0;
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                if (p0 + u < e) {
                    if (k[u] != key) {  // a piece ends inside the chunk
                        if (first && sp.x >= 0) {
                            head[(size_t)c * ncols + col] = acc;
                        } else {
                            out[(size_t)key * ncols + col] = acc;
                        }
                        first = false;
                        acc = vzero(T());
                        key = k[u];
                    }
                    acc = vadd(acc, v[u]);
                }
            }
        }
        if (key != dead) {  // the piece that ends at the chunk's end
            if (first && sp.x >= 0) {
                head[(size_t)c * ncols + col] = acc;
            } else if (sp.y >= 0) {
                tail[(size_t)c * ncols + col] = acc;
            } else {
                out[(size_t)key * ncols + col] = acc;
            }
        }
    }
    if (sp.x >= 0) {
        finish_run(sp.x, whole ? sp.y : c, kf, ncols, col0, col1, lane, L, gmask, cnt, head,
                   tail, out);
    }
    if (sp.y >= 0 && !whole) {
        finish_run(c, sp.y, kl, ncols, col0, col1, lane, L, gmask, cnt, head, tail, out);
    }
}

// The segment pass: groups of L = 2^lanes_log2 lanes walk the chunks, each
// group one slice of SLICE_FLOATS columns of the row (the slices of a
// chunk on neighbouring groups; each slice its own n_chunks counters);
// with `offsets` (the pass owns the table) they also write the empty
// rows' zeros, so every row of out is written once.
template <typename T>
__global__ void __launch_bounds__(PASS_THREADS) segment_pass(
    const T* __restrict__ g, const int* __restrict__ perm, const unsigned int* __restrict__ sk,
    const int2* __restrict__ spans, const int* __restrict__ offsets, int* cnt, T* head, T* tail,
    T* __restrict__ out, int n, int ncols, int n_rows, unsigned int dead, int chunk,
    int lanes_log2, int slices) {
    constexpr int SLICE_COLS = SLICE_FLOATS * 4 / (int)sizeof(T);
    const int L = 1 << lanes_log2;
    const int lane = threadIdx.x & (L - 1);
    const int at = (int)((blockIdx.x * PASS_THREADS + threadIdx.x) >> lanes_log2);
    const int n_groups = (int)((gridDim.x * PASS_THREADS) >> lanes_log2) / slices;
    if (at >= n_groups * slices) return;  // a whole group
    const int group = at / slices, slice = at % slices;
    const int col0 = slice * SLICE_COLS, col1 = min(ncols, col0 + SLICE_COLS);
    const unsigned int gmask =
        L == 32 ? 0xffffffffu : ((1u << L) - 1u) << ((threadIdx.x & 31) & ~(L - 1));
    const int n_chunks = (n + chunk - 1) / chunk;
    cnt += (size_t)slice * n_chunks;
    // the first row this group checks for emptiness, loaded before the walk
    const bool checks = offsets != nullptr && group < n_rows;
    const int first_lo = checks ? offsets[group] : 0, first_hi = checks ? offsets[group + 1] : 0;
    for (int c = group; c < n_chunks; c += n_groups) {
        walk_chunk(c, g, perm, sk, spans, cnt, head, tail, out, n, ncols, col0, col1, dead,
                   chunk, lane, L, gmask);
    }
    if (offsets == nullptr) return;
    for (int r = group; r < n_rows; r += n_groups) {
        if (r == group ? first_lo == first_hi : offsets[r] == offsets[r + 1]) {
            for (int col = col0 + lane; col < col1; col += L) {
                out[(size_t)r * ncols + col] = vzero(T());
            }
        }
    }
}

__device__ __forceinline__ unsigned int key_of(const void* ids, int ids_bytes,
                                               const uint8_t* live, int p, unsigned int dead) {
    if (live != nullptr && !live[p]) return dead;
    return ids_bytes == 4 ? (unsigned int)((const int32_t*)ids)[p]
                          : (unsigned int)((const int64_t*)ids)[p];
}

// The short chain's sort: keys made from coalesced loads, staged in
// shared memory and read back blocked, then sorted by cub's
// BlockRadixSort, which keeps equal keys in that (position) order, over
// the low h bits in which the smallest and largest key differ (every key
// between them shares the bits above; the positions past n take the
// largest key, so they sort last). Where h and the position's bits fit 32,
// each key and its position sort as one word, keys only; else as pairs.
// Then, from shared memory: the sorted keys and positions written out
// coalesced; where `offsets` is given (V <= n), the row offsets from the
// runs' starts and each chunk's crossing runs from them, else by binary
// search; the run counters zeroed.
template <int THREADS, int IPT>
__global__ void __launch_bounds__(THREADS) sort_block(
    const void* __restrict__ ids, int ids_bytes, const uint8_t* __restrict__ live, int n,
    unsigned int dead, int chunk, int* __restrict__ perm, unsigned int* __restrict__ sk,
    int2* __restrict__ spans, int* __restrict__ cnt, int n_cnt, int* __restrict__ offsets) {
    constexpr int N = THREADS * IPT;
    constexpr int POS_BITS = log2_of(N);
    static_assert(N == 1 << POS_BITS, "THREADS * IPT is a power of two");
    using SortPairs = cub::BlockRadixSort<unsigned int, THREADS, IPT, int, RADIX_BITS>;
    using SortKeys = cub::BlockRadixSort<unsigned int, THREADS, IPT, cub::NullType, RADIX_BITS>;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ unsigned int key_min, key_max;
    unsigned int* keys_s = reinterpret_cast<unsigned int*>(smem);
    int* vals_s = reinterpret_cast<int*>(keys_s + N);
    int* offs_s = vals_s + N;  // n_rows + 1 <= N + 1 where the offsets are asked for
    // the keys, one register each
    unsigned int kv[IPT];
    unsigned int lo = 0xffffffffu, hi = 0;
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        const int p = i * THREADS + threadIdx.x;
        kv[i] = p < n ? key_of(ids, ids_bytes, live, p, dead) : 0u;
        if (p < n) {
            lo = min(lo, kv[i]);
            hi = max(hi, kv[i]);
        }
    }
    if (threadIdx.x == 0) {
        key_min = 0xffffffffu;
        key_max = 0;
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) {
        atomicMin(&key_min, lo);
        atomicMax(&key_max, hi);
    }
    __syncthreads();
    const unsigned int top = key_max, low = key_min;
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        const int p = i * THREADS + threadIdx.x;
        keys_s[p] = p >= n ? top : kv[i];
    }
    const int h = 32 - __clz(low ^ top);
    __syncthreads();
    unsigned int keys[IPT];
    int vals[IPT];
    if (h + POS_BITS <= 32) {
        const unsigned int mask = (1u << h) - 1u;
#pragma unroll
        for (int i = 0; i < IPT; ++i) {
            keys[i] = ((keys_s[threadIdx.x * IPT + i] & mask) << POS_BITS) | (threadIdx.x * IPT + i);
        }
        __syncthreads();
        if (h > 0) {
            SortKeys(*reinterpret_cast<typename SortKeys::TempStorage*>(smem))
                .Sort(keys, POS_BITS, POS_BITS + h);
            __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < IPT; ++i) {
            vals[i] = (int)(keys[i] & ((1u << POS_BITS) - 1u));
            keys[i] = (low & ~mask) | (keys[i] >> POS_BITS);
        }
    } else {
#pragma unroll
        for (int i = 0; i < IPT; ++i) {
            keys[i] = keys_s[threadIdx.x * IPT + i];
            vals[i] = threadIdx.x * IPT + i;
        }
        __syncthreads();
        SortPairs(*reinterpret_cast<typename SortPairs::TempStorage*>(smem))
            .Sort(keys, vals, 0, h);
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        keys_s[threadIdx.x * IPT + i] = keys[i];
        vals_s[threadIdx.x * IPT + i] = vals[i];
    }
    __syncthreads();
    for (int p = threadIdx.x; p < n; p += THREADS) {
        sk[p] = keys_s[p];
        perm[p] = vals_s[p];
    }
    for (int c = threadIdx.x; c < n_cnt; c += THREADS) cnt[c] = 0;
    const int n_chunks = (n + chunk - 1) / chunk;
    if (offsets == nullptr) {
        for (int c = threadIdx.x; c < n_chunks; c += THREADS) {
            spans[c] = chunk_span(keys_s, n, c, chunk, dead);
        }
        return;
    }
    // each run's start is the offset of its key and of the empty rows
    // before it; the rows past the last key begin at n
    for (int p = threadIdx.x; p < n; p += THREADS) {
        const int k = (int)keys_s[p], prev = p == 0 ? -1 : (int)keys_s[p - 1];
        for (int r = prev + 1; r <= k; ++r) offs_s[r] = p;
    }
    const int last = (int)keys_s[n - 1];
    for (int r = last + 1 + threadIdx.x; r <= (int)dead; r += THREADS) offs_s[r] = n;
    __syncthreads();
    for (int r = threadIdx.x; r <= (int)dead; r += THREADS) offsets[r] = offs_s[r];
    for (int c = threadIdx.x; c < n_chunks; c += THREADS) {
        const int s = c * chunk, e = min(s + chunk, n);
        const unsigned int kf = keys_s[s], kl = keys_s[e - 1];
        int2 sp = make_int2(-1, -1);
        if (kf != dead && s > 0 && keys_s[s - 1] == kf) sp.x = offs_s[kf] / chunk;
        if (kl != dead && e < n && keys_s[e] == kl) sp.y = (offs_s[kl + 1] - 1) / chunk;
        spans[c] = sp;
    }
}

__global__ void make_keys(const void* __restrict__ ids, int ids_bytes,
                          const uint8_t* __restrict__ live, int n, unsigned int dead,
                          int n_cnt, unsigned int* __restrict__ keys, int* __restrict__ pos,
                          int* __restrict__ cnt) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n_cnt) cnt[i] = 0;
    if (i >= n) return;
    keys[i] = key_of(ids, ids_bytes, live, i, dead);
    pos[i] = i;
}

// A plan's row offsets (V + 1) and, where `spans` is given, its chunk
// spans from its sorted keys.
__global__ void plan_tables(const unsigned int* __restrict__ sk, int n, int n_rows, int chunk,
                            int* __restrict__ offsets, int2* __restrict__ spans) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const unsigned int dead = (unsigned int)n_rows;
    if (i <= n_rows) offsets[i] = lower_bound(sk, n, (unsigned int)i);
    if (spans != nullptr && i < (n + chunk - 1) / chunk) {
        spans[i] = chunk_span(sk, n, i, chunk, dead);
    }
}

int bits_for(unsigned int dead) {
    int end_bit = 1;
    while (end_bit < 32 && (dead >> end_bit) != 0) ++end_bit;
    return end_bit;
}

// The one-block sort; the offsets, where asked for, from its shared
// memory only where they fit there (n_rows <= THREADS * IPT, always so
// for a call's own table), else from the sorted keys by `plan_tables` (a
// plan of few ids into many rows).
template <int THREADS, int IPT>
cudaError_t launch_sort_block(const void* ids, int ids_bytes, const uint8_t* live, int n,
                              unsigned int dead, int chunk, int* perm, unsigned int* sk,
                              int2* spans, int* cnt, int n_cnt, int* offsets, cudaStream_t s) {
    const int n_rows = (int)dead;
    const bool fit = n_rows <= THREADS * IPT;
    using Pairs = cub::BlockRadixSort<unsigned int, THREADS, IPT, int, RADIX_BITS>;
    using Keys = cub::BlockRadixSort<unsigned int, THREADS, IPT, cub::NullType, RADIX_BITS>;
    // the sorts' scratch or the staged keys and positions, then the offsets
    static const size_t bytes = std::max({sizeof(typename Pairs::TempStorage),
                                          sizeof(typename Keys::TempStorage),
                                          (size_t)8 * THREADS * IPT}) +
                                4 * (THREADS * IPT + 1);
    static const cudaError_t set = cudaFuncSetAttribute(
        sort_block<THREADS, IPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (set != cudaSuccess) return set;
    sort_block<THREADS, IPT><<<1, THREADS, bytes, s>>>(ids, ids_bytes, live, n, dead, chunk,
                                                       perm, sk, spans, cnt, n_cnt,
                                                       fit ? offsets : nullptr);
    if (offsets != nullptr && !fit) {
        plan_tables<<<(n_rows + 256) / 256, 256, 0, s>>>(sk, n, n_rows, chunk, offsets, nullptr);
    }
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_pass(const float* g, int n, int d, int n_rows, int chunk, const int* perm,
                        const unsigned int* sk, const int2* spans, const int* offsets, int* cnt,
                        float* head, float* tail, float* out, cudaStream_t s) {
    const int ncols = sizeof(T) == 16 ? d / 4 : d;
    const int slices = (d + SLICE_FLOATS - 1) / SLICE_FLOATS;
    int lanes_log2 = 0;
    while (lanes_log2 < 5 && (1 << lanes_log2) < ncols) ++lanes_log2;
    const int n_chunks = (n + chunk - 1) / chunk;
    long long groups = n_chunks;
    if (offsets != nullptr) {
        const long long zero_groups = ((long long)n_rows + ZERO_ROWS - 1) / ZERO_ROWS;
        if (zero_groups > groups) groups = zero_groups;
    }
    const long long threads = (groups * slices) << lanes_log2;
    const long long blocks = (threads + PASS_THREADS - 1) / PASS_THREADS;
    if (blocks == 0) return cudaSuccess;
    segment_pass<T><<<(unsigned int)(blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL),
                      PASS_THREADS, 0, s>>>(
        (const T*)g, perm, sk, spans, offsets, cnt, (T*)head, (T*)tail, (T*)out, n, ncols,
        n_rows, (unsigned int)n_rows, chunk, lanes_log2, slices);
    return cudaGetLastError();
}

cudaError_t pass(const float* g, int n, int d, int n_rows, int chunk, const int* perm,
                 const unsigned int* sk, const int2* spans, const int* offsets, int* cnt,
                 float* head, float* tail, float* out, cudaStream_t s) {
    const bool vec = d % 4 == 0 && ((uintptr_t)g & 15) == 0 && ((uintptr_t)out & 15) == 0 &&
                     ((uintptr_t)head & 15) == 0 && ((uintptr_t)tail & 15) == 0;
    return vec ? launch_pass<float4>(g, n, d, n_rows, chunk, perm, sk, spans, offsets, cnt, head,
                                     tail, out, s)
               : launch_pass<float>(g, n, d, n_rows, chunk, perm, sk, spans, offsets, cnt, head,
                                    tail, out, s);
}

}  // namespace

extern "C" {

// The most positions the one-block sort takes.
int embed_grad_block_max(void) { return BLOCK_MAX; }

// Columns of a row's slice: the segment pass takes ceil(D / this) slices,
// each with its own n_chunks run counters.
int embed_grad_slice_floats(void) { return SLICE_FLOATS; }

// Bytes of device-wide sort scratch for n pairs (the caller allocates them).
int embed_grad_sort_bytes(int n, size_t* bytes) {
    *bytes = 0;
    return (int)cub::DeviceRadixSort::SortPairs(
        nullptr, *bytes, (const unsigned int*)nullptr, (unsigned int*)nullptr,
        (const int*)nullptr, (int*)nullptr, n, 0, 32);
}

// The sort of a call or of a plan: perm (n) the positions in stable order
// of their keys (live ? id : n_rows), sk (n) the sorted keys, cnt (n_cnt:
// one a chunk for each slice of the rows the pass will sum) zeroed. With
// `block` (n <= BLOCK_MAX; the caller chooses the route) one block
// (`sort_block`) also writes spans (one int2 a chunk, 8-byte aligned)
// and, where `offsets` is given (n_rows <= n, or a plan), the row offsets
// (n_rows + 1). Without: `make_keys` into keys_in / pos_in (n each), the
// device-wide radix sort (temp: embed_grad_sort_bytes), and where spans
// and offsets are given (a plan), `plan_tables` for both. Returns
// cudaGetLastError() (0 on success).
int embed_grad_sort(const void* ids, int ids_bytes, const uint8_t* live, int n, int n_rows,
                    int chunk, int block, unsigned int* keys_in, int* pos_in, int* perm,
                    unsigned int* sk, int* spans, int* cnt, int n_cnt, int* offsets,
                    void* temp, size_t temp_bytes, void* stream) {
    if (n <= 0 || n_rows <= 0 || chunk <= 0 || n_cnt < 0 ||
        (ids_bytes != 4 && ids_bytes != 8)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned int dead = (unsigned int)n_rows;
    int2* sp = (int2*)spans;
    if (block) {
        if (n > BLOCK_MAX || sp == nullptr) return (int)cudaErrorInvalidValue;
        if (n <= 2048) {
            return (int)launch_sort_block<256, 8>(ids, ids_bytes, live, n, dead, chunk, perm, sk,
                                                  sp, cnt, n_cnt, offsets, s);
        }
        if (n <= 8192) {
            return (int)launch_sort_block<1024, 8>(ids, ids_bytes, live, n, dead, chunk, perm,
                                                   sk, sp, cnt, n_cnt, offsets, s);
        }
        return (int)launch_sort_block<1024, 16>(ids, ids_bytes, live, n, dead, chunk, perm, sk,
                                                sp, cnt, n_cnt, offsets, s);
    }
    const int n_chunks = (n + chunk - 1) / chunk;
    make_keys<<<(max(n, n_cnt) + 255) / 256, 256, 0, s>>>(ids, ids_bytes, live, n, dead, n_cnt,
                                                         keys_in, pos_in, cnt);
    cudaError_t err = cub::DeviceRadixSort::SortPairs(temp, temp_bytes, keys_in, sk, pos_in, perm,
                                                      n, 0, bits_for(dead), s);
    if (err != cudaSuccess) return (int)err;
    if (sp != nullptr && offsets != nullptr) {
        const int items = max(n_rows + 1, n_chunks);
        plan_tables<<<(items + 255) / 256, 256, 0, s>>>(sk, n, n_rows, chunk, offsets, sp);
    }
    return (int)cudaGetLastError();
}

// The segment pass over sorted arrays (a plan's, or a call's from
// embed_grad_sort): out (n_rows, D) written whole where `offsets` is
// given, else only its touched rows (the caller zeroed it); spans null:
// found by binary search. head and tail: one D-row a chunk each; cnt:
// n_chunks zeroed counters for each slice of D (embed_grad_slice_floats),
// zero again after the pass.
int embed_grad_pass(const float* g, int n, int d, int n_rows, int chunk, const int* perm,
                    const unsigned int* sk, const int* spans, const int* offsets, int* cnt,
                    float* head, float* tail, float* out, void* stream) {
    if (n < 0 || d <= 0 || n_rows <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
    return (int)pass(g, n, d, n_rows, chunk, perm, sk, (const int2*)spans, offsets, cnt, head,
                     tail, out, (cudaStream_t)stream);
}

// The table gradient of a call without a plan: embed_grad_sort on the
// route `block` gives (cnt: n_chunks counters for each slice of D, zeroed
// by the sort), a memset of out where `offsets` is null (always on the
// device-wide route), then the segment pass.
int embed_grad_backward(const float* g, const void* ids, int ids_bytes, const uint8_t* live,
                        int n, int d, int n_rows, int chunk, int block, unsigned int* keys_in,
                        int* pos_in, int* perm, unsigned int* sk, int* spans, int* cnt,
                        int* offsets, void* temp, size_t temp_bytes, float* head, float* tail,
                        float* out, void* stream) {
    if (n <= 0 || d <= 0 || n_rows <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
    if (block ? n > BLOCK_MAX : offsets != nullptr) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int n_cnt = (n + chunk - 1) / chunk * ((d + SLICE_FLOATS - 1) / SLICE_FLOATS);
    int err = embed_grad_sort(ids, ids_bytes, live, n, n_rows, chunk, block, keys_in, pos_in,
                              perm, sk, block ? spans : nullptr, cnt, n_cnt, offsets, temp,
                              temp_bytes, stream);
    if (err != 0) return err;
    if (offsets == nullptr) {
        cudaError_t e = cudaMemsetAsync(out, 0, (size_t)n_rows * d * sizeof(float), s);
        if (e != cudaSuccess) return (int)e;
    }
    return (int)pass(g, n, d, n_rows, chunk, perm, sk,
                     block ? (const int2*)spans : nullptr, offsets, cnt, head, tail,
                     out, s);
}

}  // extern "C"
