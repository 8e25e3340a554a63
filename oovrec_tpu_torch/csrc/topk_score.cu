// Fused full-corpus retrieval scoring: exact top-k of U @ I^T after a
// per-user exclusion bitmap, emitted as per-item-range candidates.
//
// Replaces the Pallas TPU kernel oovrec_tpu/ops/topk_score.py:
// fused_topk_scores (body `_kernel`, pallas_call at :134). It computes the
// same function; the blocking is Hopper's own, not the TPU's.
//
// What bounds it on the H100 (B=256, N=1,000,000, D=64, k=20): 2*B*N*D =
// 33.5 GFLOP of f32 FMA on CUDA cores (0.49 ms at 67 TFLOP/s) against a
// 256 MB item table plus a 32 MB bitmap (0.09 ms at 3.35 TB/s): operations.
// The selection must therefore cost far less than the product. The design:
//
// 1. Score tile at a SIMT-GEMM shape. A block owns TU users (128 for k <= 32)
//    and walks a contiguous range of 128-item tiles (the wrapper splits the
//    corpus into about one range per SM and user tile). The user tile stays
//    in shared memory for the whole range; item tiles stream through a
//    3-stage cp.async ring of 32-deep slices, so the next slice loads while
//    the current one is multiplied. Each thread keeps an (RU users x 8
//    items) register tile and reads operands as float4 along d (at TU = 128:
//    4 x 16-byte shared loads per 32 FMAs per depth pair); every score is
//    a plain ascending-d FMA chain in f32 (no TF32).
// 2. Selection by threshold, not by k rounds. Each user keeps a running
//    list of its best KCAP keys (key = order-preserving score bits << 32 |
//    ~index, so one 64-bit compare orders by score desc, index asc) and
//    the k-th key as a threshold. A masked score that does not reach the
//    threshold's value is dropped with one float compare; a survivor is
//    appended to the user's CAP-slot buffer with a shared atomic. A warp
//    merges a buffer into its list by rank counting (no sort) when some
//    buffer overflows (the survivors that did not fit wait in a register
//    mask and are offered again against the new threshold) and at the end
//    of the range. In a range of n items about k*ln(n/k) scores survive.
// 3. Output (n_ranges, B, k) values and global indices, ranges in ascending
//    item order, each range's top-k in (score desc, index asc) order. The
//    merge to (B, k) is a stable sort outside the kernel, as lax.top_k is
//    outside in JAX.
// Excluded items (bit i % 32 of word i / 32 of the user's bitmap row) score
// NEG_INF = -3.0e38; items past N score -inf and keep their index, so the
// range holding N offers N, N+1, ... when N < k. Every range spans at least
// k indices, so no list slot is left empty. The users a block owns shrink
// with k (k classes 32 / 128 / 512 / 1024 as template parameters) so that
// the lists fit in shared memory. Where the user tile does not fit whole (a
// deep D) it rides the ring in 32-deep slices beside the item slices (`SU`),
// read again for every item tile.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;     // 16 x 16 threads
constexpr int TI = 128;          // items per tile
constexpr int DK = 32;           // depth of one pipeline stage
constexpr int STAGES = 3;
constexpr int IS_ROW = DK + 4;   // padded item row: conflict-free float4 reads
constexpr int WORDS = TI / 32;   // bitmap words per user and tile
constexpr int MAX_SMEM = 232448;
constexpr float NEG_INF = -3.0e38f;

// k classes: users per block, list capacity (largest k), survivor buffer
template <int CLS> struct KClass;
template <> struct KClass<0> { static constexpr int TU = 128, KCAP = 32, CAP = 64; };
template <> struct KClass<1> { static constexpr int TU = 64, KCAP = 128, CAP = 64; };
template <> struct KClass<2> { static constexpr int TU = 16, KCAP = 512, CAP = 128; };
template <> struct KClass<3> { static constexpr int TU = 16, KCAP = 1024, CAP = 128; };
constexpr int N_CLASSES = 4;

// the user tile: whole ([TU][Dp + 4]) or, with `su`, streamed ([STAGES][TU][IS_ROW])
template <int CLS>
size_t smem_bytes(int D, bool su) {
    using C = KClass<CLS>;
    const size_t Dp = (size_t)(D + DK - 1) / DK * DK;
    const size_t users = su ? (size_t)STAGES * C::TU * IS_ROW : (size_t)C::TU * (Dp + 4);
    return 8 * (size_t)C::TU * (C::KCAP + C::CAP + 1) + 4 * 2 * (size_t)C::TU + 16 +
           4 * (size_t)STAGES * C::TU * WORDS + 4 * users + 4 * (size_t)STAGES * TI * IS_ROW;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// larger key = better: score descending, then index ascending; 0 loses to
// every real candidate (a real key has a nonzero low word ~index)
__device__ __forceinline__ uint64_t make_key(float v, int idx) {
    uint32_t u = __float_as_uint(v + 0.0f);  // -0 -> +0
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ((uint64_t)u << 32) | (uint64_t)(~(uint32_t)idx);
}

__device__ __forceinline__ float key_value(uint64_t key) {
    uint32_t u = (uint32_t)(key >> 32);
    u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
    return __uint_as_float(u);
}

__device__ __forceinline__ int key_index(uint64_t key) { return (int)~(uint32_t)key; }

// Offer a key that passed the float test: false when the user's buffer is
// full (the caller keeps it pending and the block merges).
template <int CAP>
__device__ __forceinline__ bool offer(uint64_t key, int u, const uint64_t* thr_k, int* cnt,
                                      uint64_t* bufs, int* flag) {
    if (key <= thr_k[u]) return true;
    const int slot = atomicAdd(&cnt[u], 1);
    if (slot < CAP) {
        bufs[u * CAP + slot] = key;
        return true;
    }
    *flag = 1;
    return false;
}

// Warp w merges the buffers of users w, w + 8, ... into their lists: each
// element's new position is its rank among list + buffer (keys are unique),
// then the k-th key becomes the threshold.
template <int TU, int KCAP, int CAP>
__device__ void merge_buffers(uint64_t* lists, const uint64_t* bufs, uint64_t* thr_k,
                              float* thr_v, int* cnt, int k, int warp, int lane) {
    constexpr int NL = KCAP / 32, NB = CAP / 32;
    for (int u = warp; u < TU; u += THREADS / 32) {
        const int m = min(cnt[u], CAP);
        if (m == 0) continue;
        uint64_t* L = lists + u * KCAP;
        const uint64_t* buf = bufs + u * CAP;
        uint64_t lx[NL], bx[NB];
        int lr[NL], br[NB];
#pragma unroll
        for (int e = 0; e < NL; ++e) {
            lx[e] = L[lane + 32 * e];
            lr[e] = lane + 32 * e;
        }
#pragma unroll
        for (int e = 0; e < NB; ++e) {
            const int j = lane + 32 * e;
            bx[e] = j < m ? buf[j] : 0ull;
            br[e] = 0;
        }
        for (int t = 0; t < m; ++t) {
            const uint64_t y = buf[t];
#pragma unroll
            for (int e = 0; e < NL; ++e) lr[e] += y > lx[e];
#pragma unroll
            for (int e = 0; e < NB; ++e) br[e] += y > bx[e];
        }
#pragma unroll
        for (int e = 0; e < NB; ++e) {
            int lo = 0, hi = KCAP;  // list entries greater than bx[e]
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (L[mid] > bx[e]) lo = mid + 1; else hi = mid;
            }
            br[e] += lo;
        }
        __syncwarp();
#pragma unroll
        for (int e = 0; e < NL; ++e)
            if (lr[e] < KCAP) L[lr[e]] = lx[e];
#pragma unroll
        for (int e = 0; e < NB; ++e)
            if (lane + 32 * e < m && br[e] < KCAP) L[br[e]] = bx[e];
        __syncwarp();
        if (lane == 0) {
            const uint64_t kth = L[k - 1];
            thr_k[u] = kth;
            thr_v[u] = kth ? key_value(kth) : -CUDART_INF_F;
            cnt[u] = 0;
        }
    }
}

template <int CLS, bool VEC, bool SU>
__global__ void __launch_bounds__(THREADS, 1)
topk_range_kernel(const float* __restrict__ U, const float* __restrict__ I,
                  const uint32_t* __restrict__ bitmap, int B, int N, int D, int Dp,
                  int W, int k, int n_tiles, int n_ranges, float* __restrict__ out_v,
                  int32_t* __restrict__ out_i) {
    using C = KClass<CLS>;
    constexpr int TU = C::TU, KCAP = C::KCAP, CAP = C::CAP;
    constexpr int RU = TU / 16;  // users per thread: ty + 16 * i
    extern __shared__ __align__(16) unsigned char smem[];
    uint64_t* lists = reinterpret_cast<uint64_t*>(smem);  // [TU][KCAP]
    uint64_t* bufs = lists + TU * KCAP;                   // [TU][CAP]
    uint64_t* thr_k = bufs + TU * CAP;                    // [TU]
    float* thr_v = reinterpret_cast<float*>(thr_k + TU);  // [TU]
    int* cnt = reinterpret_cast<int*>(thr_v + TU);        // [TU]
    int* flag = cnt + TU;                                 // [4]
    uint32_t* Bs = reinterpret_cast<uint32_t*>(flag + 4);  // [STAGES][TU][WORDS]
    float* Us = reinterpret_cast<float*>(Bs + STAGES * TU * WORDS);  // [TU][Dp + 4] or
                                                          // [STAGES][TU][IS_ROW] (SU)
    float* Is = Us + (SU ? STAGES * TU * IS_ROW : TU * (Dp + 4));  // [STAGES][TI][IS_ROW]

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int lane = tid & 31, warp = tid >> 5;
    const int b0 = blockIdx.x * TU;
    const int r = blockIdx.y;
    const int t_beg = (int)((long long)r * n_tiles / n_ranges);
    const int t_end = (int)((long long)(r + 1) * n_tiles / n_ranges);
    const int nc = Dp / DK;
    const int steps = (t_end - t_beg) * nc;
    const int us_row = SU ? IS_ROW : Dp + 4;

    for (int e = tid; e < TU * KCAP; e += THREADS) lists[e] = 0ull;
    for (int u = tid; u < TU; u += THREADS) {
        const bool live = b0 + u < B;  // a padded user takes no candidate
        thr_k[u] = live ? 0ull : ~0ull;
        thr_v[u] = live ? -CUDART_INF_F : CUDART_INF_F;
        cnt[u] = 0;
    }
    if (tid == 0) flag[0] = 0;
    if (!SU)
        for (int u = warp; u < TU; u += THREADS / 32)
            for (int d = lane; d < Dp; d += 32)
                Us[u * us_row + d] = (b0 + u < B && d < D) ? U[(size_t)(b0 + u) * D + d] : 0.0f;

    auto load_stage = [&](int s) {
        if (s < steps) {
            const int t = t_beg + s / nc, c = s - (s / nc) * nc;
            float* dst = Is + (s % STAGES) * TI * IS_ROW;
            const int item0 = t * TI, d0 = c * DK;
            if (VEC) {
                for (int e = tid; e < TI * (DK / 4); e += THREADS) {
                    const int row = e >> 3, d = d0 + (e & 7) * 4;
                    const bool ok = item0 + row < N && d < D;
                    cp_async16(dst + row * IS_ROW + (e & 7) * 4,
                               ok ? I + (size_t)(item0 + row) * D + d : I, ok ? 16 : 0);
                }
            } else {
                for (int e = tid; e < TI * DK; e += THREADS) {
                    const int row = e >> 5, d = d0 + (e & 31);
                    const bool ok = item0 + row < N && d < D;
                    cp_async4(dst + row * IS_ROW + (e & 31),
                              ok ? I + (size_t)(item0 + row) * D + d : I, ok ? 4 : 0);
                }
            }
            if (SU) {  // the users' slice of the same depth
                float* udst = Us + (s % STAGES) * TU * IS_ROW;
                for (int e = tid; e < TU * DK; e += THREADS) {
                    const int u = e >> 5, d = d0 + (e & 31);
                    const bool ok = b0 + u < B && d < D;
                    cp_async4(udst + u * IS_ROW + (e & 31),
                              ok ? U + (size_t)(b0 + u) * D + d : U, ok ? 4 : 0);
                }
            }
            if (c == 0) {
                uint32_t* bdst = Bs + (t % STAGES) * TU * WORDS;
                for (int e = tid; e < TU * WORDS; e += THREADS) {
                    const int u = e / WORDS, word = t * WORDS + e % WORDS;
                    const bool ok = b0 + u < B && word < W;
                    cp_async4(bdst + e, ok ? bitmap + (size_t)(b0 + u) * W + word : bitmap,
                              ok ? 4 : 0);
                }
            }
        }
        cp_async_commit();  // an empty group keeps the wait count uniform
    };

    for (int s = 0; s < STAGES - 1; ++s) load_stage(s);

    float acc[RU][8];
    for (int s = 0; s < steps; ++s) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        load_stage(s + STAGES - 1);
        const int c = s % nc;
        if (c == 0) {
#pragma unroll
            for (int i = 0; i < RU; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
        }
        const float* is = Is + (s % STAGES) * TI * IS_ROW;
        const float* us = SU ? Us + (s % STAGES) * TU * IS_ROW : Us + c * DK;
#pragma unroll 2
        for (int dd = 0; dd < DK; dd += 4) {
            float4 iv[8], uv[RU];
#pragma unroll
            for (int j = 0; j < 8; ++j)
                iv[j] = *reinterpret_cast<const float4*>(&is[(tx + 16 * j) * IS_ROW + dd]);
#pragma unroll
            for (int i = 0; i < RU; ++i)
                uv[i] = *reinterpret_cast<const float4*>(&us[(ty + 16 * i) * us_row + dd]);
#pragma unroll
            for (int i = 0; i < RU; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    acc[i][j] = fmaf(uv[i].x, iv[j].x, acc[i][j]);
                    acc[i][j] = fmaf(uv[i].y, iv[j].y, acc[i][j]);
                    acc[i][j] = fmaf(uv[i].z, iv[j].z, acc[i][j]);
                    acc[i][j] = fmaf(uv[i].w, iv[j].w, acc[i][j]);
                }
        }
        if (c != nc - 1) continue;

        // the tile is scored: mask, then offer what reaches the threshold
        const int t = t_beg + s / nc;
        const uint32_t* bw = Bs + (t % STAGES) * TU * WORDS;
        uint64_t pending = 0;  // bit 8 * i + j: a survivor that did not fit
#pragma unroll
        for (int i = 0; i < RU; ++i) {
            const int u = ty + 16 * i;
            const float tv = thr_v[u];
            const uint4 w4 = *reinterpret_cast<const uint4*>(&bw[u * WORDS]);
            const uint32_t words[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int col = tx + 16 * j;  // word col / 32 = j / 2
                const int item = t * TI + col;
                float v = acc[i][j];
                if (item >= N) {
                    v = -CUDART_INF_F;
                } else if ((words[j >> 1] >> (col & 31)) & 1u) {
                    v = NEG_INF;
                }
                acc[i][j] = v;
                if (v >= tv && !offer<CAP>(make_key(v, item), u, thr_k, cnt, bufs, flag))
                    pending |= 1ull << (8 * i + j);
            }
        }
        __syncthreads();
        for (;;) {  // some buffer overflowed: merge, then offer the rest again
            const int again = flag[0];
            __syncthreads();
            if (!again) break;
            if (tid == 0) flag[0] = 0;
            merge_buffers<TU, KCAP, CAP>(lists, bufs, thr_k, thr_v, cnt, k, warp, lane);
            __syncthreads();
#pragma unroll
            for (int i = 0; i < RU; ++i) {
                const int u = ty + 16 * i;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const uint64_t bit = 1ull << (8 * i + j);
                    if (!(pending & bit)) continue;
                    const int item = t * TI + tx + 16 * j;
                    if (acc[i][j] < thr_v[u] ||
                        offer<CAP>(make_key(acc[i][j], item), u, thr_k, cnt, bufs, flag))
                        pending &= ~bit;
                }
            }
            __syncthreads();
        }
    }
    cp_async_wait<0>();
    __syncthreads();
    merge_buffers<TU, KCAP, CAP>(lists, bufs, thr_k, thr_v, cnt, k, warp, lane);
    __syncthreads();

    for (int u = warp; u < TU; u += THREADS / 32) {
        const int b = b0 + u;
        if (b >= B) break;
        const size_t base = ((size_t)r * B + b) * k;
        for (int e = lane; e < k; e += 32) {
            const uint64_t key = lists[u * KCAP + e];
            out_v[base + e] = key_value(key);
            out_i[base + e] = key_index(key);
        }
    }
}

template <int CLS, bool VEC, bool SU>
int launch(const float* U, const float* I, const uint32_t* bitmap, int B, int N, int D,
           int W, int k, int n_tiles, int n_ranges, float* out_v, int32_t* out_i,
           cudaStream_t stream) {
    const size_t smem = smem_bytes<CLS>(D, SU);
    if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(topk_range_kernel<CLS, VEC, SU>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int Dp = (D + DK - 1) / DK * DK;
    const dim3 grid((B + KClass<CLS>::TU - 1) / KClass<CLS>::TU, n_ranges);
    topk_range_kernel<CLS, VEC, SU><<<grid, THREADS, smem, stream>>>(
        U, I, bitmap, B, N, D, Dp, W, k, n_tiles, n_ranges, out_v, out_i);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int topk_tile_items() { return TI; }

int topk_class_count() { return N_CLASSES; }

// users per block, list capacity and survivor buffer of a k class
int topk_class_users(int cls) {
    return cls == 0 ? KClass<0>::TU : cls == 1 ? KClass<1>::TU
         : cls == 2 ? KClass<2>::TU : KClass<3>::TU;
}

int topk_class_capacity(int cls) {
    return cls == 0 ? KClass<0>::KCAP : cls == 1 ? KClass<1>::KCAP
         : cls == 2 ? KClass<2>::KCAP : KClass<3>::KCAP;
}

int topk_class_buffer(int cls) {
    return cls == 0 ? KClass<0>::CAP : cls == 1 ? KClass<1>::CAP
         : cls == 2 ? KClass<2>::CAP : KClass<3>::CAP;
}

long long topk_smem_bytes(int cls, int D, int su) {
    return (long long)(cls == 0 ? smem_bytes<0>(D, su) : cls == 1 ? smem_bytes<1>(D, su)
                     : cls == 2 ? smem_bytes<2>(D, su) : smem_bytes<3>(D, su));
}

// Launches on `stream`; returns cudaGetLastError() (0 on success). The
// wrapper chooses the k class `cls` and the split of the n_tiles item tiles
// into n_ranges ranges (each at least ceil(k / 128) tiles) and whether the
// user tile streams (`su`); `vec` asks for 16-byte item loads (D % 4 == 0
// and a 16-byte aligned table).
int topk_score_launch(const float* U, const float* I, const int32_t* bitmap, int B, int N,
                      int D, int W, int k, int cls, int su, int n_tiles, int n_ranges,
                      int vec, float* out_v, int32_t* out_i, void* stream) {
    if (B <= 0 || N <= 0 || D <= 0 || k <= 0 || cls < 0 || cls >= N_CLASSES ||
        k > topk_class_capacity(cls) || n_ranges <= 0 || n_ranges > 65535 ||
        (long long)n_tiles * TI < N || (long long)n_tiles * TI < k ||
        (long long)(n_tiles / n_ranges) * TI < k) {
        return (int)cudaErrorInvalidValue;
    }
    const uint32_t* bm = reinterpret_cast<const uint32_t*>(bitmap);
    cudaStream_t st = (cudaStream_t)stream;
#define TOPK_LAUNCH_AS(C, V, S) \
    return launch<C, V, S>(U, I, bm, B, N, D, W, k, n_tiles, n_ranges, out_v, out_i, st)
#define TOPK_LAUNCH(C)                     \
    if (vec) {                             \
        if (su) TOPK_LAUNCH_AS(C, true, true); \
        TOPK_LAUNCH_AS(C, true, false);    \
    }                                      \
    if (su) TOPK_LAUNCH_AS(C, false, true); \
    TOPK_LAUNCH_AS(C, false, false)
    if (cls == 0) { TOPK_LAUNCH(0); }
    if (cls == 1) { TOPK_LAUNCH(1); }
    if (cls == 2) { TOPK_LAUNCH(2); }
    TOPK_LAUNCH(3);
#undef TOPK_LAUNCH
#undef TOPK_LAUNCH_AS
}

}  // extern "C"
