// Fused full-corpus retrieval scoring: exact top-k of U @ I^T after a
// per-user exclusion bitmap, emitted as per-item-block candidates.
//
// Replaces the Pallas TPU kernel oovrec_tpu/ops/topk_score.py:
// fused_topk_scores (body `_kernel`, pallas_call at :134). It computes the
// same function; the blocking is Hopper's own, not the TPU's.
//
// One CUDA block per (user tile of TU users x item block of TN items),
// user tiles on the fast grid axis so the blocks that share an item block
// run together and read it from L2. The block
//   1. forms the TU x TN f32 score tile in shared memory: U tile held in
//      shared memory for all of D, items streamed in TC x DK slices, each
//      thread a 4 x 4 register tile, a plain FMA loop over d (no TF32);
//   2. applies the exclusion bitmap (bit i % 32 of word i / 32): excluded
//      items score NEG_INF = -3.0e38, items past N score -inf;
//   3. runs k rounds of warp-wide argmax then suppress, one warp per user.
//      Ties go to the lowest item index, as jnp.argmax does. A picked item
//      is suppressed by a taken bit, not by overwriting its score, so the
//      rounds emit the block's exact top-k in (score desc, index asc)
//      order, dead slots included: once the live items run out they are
//      the lowest excluded items, each once (the TPU kernel repeats one
//      index there; both carry NEG_INF and no caller counts them).
// Output: (n_blocks, B, k) values and global indices. The merge to (B, k)
// is a stable sort outside the kernel, as lax.top_k is outside in JAX.
//
// Bound at the main-path shapes (B=256, N=1,000,000, D=64, k=20): 2*B*N*D
// = 33.5 GFLOP of f32 FMA on CUDA cores (0.50 ms at 67 TFLOP/s) against a
// read of 256 MB of item table plus a 32 MB bitmap (0.09 ms at 3.35 TB/s),
// so it is bound by operations; the 7-slice evaluator launches it 4 times
// per user batch. This first version is simple and right: wgmma/TMA tiles
// for the score product and a threshold to cut the selection rounds come
// later.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TU = 32;          // users per block
constexpr int TN = 512;         // items per block (one candidate block)
constexpr int TC = 128;         // items per score chunk
constexpr int DK = 32;          // depth of one item slice
constexpr int THREADS = 256;    // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int SLOTS = TN / 32;  // items per lane in the selection
constexpr int US_ROW = TU + 1;  // padded rows: conflict-free stores
constexpr int IS_ROW = TC + 1;
constexpr float NEG_INF = -3.0e38f;
constexpr int NO_IDX = 0x7fffffff;  // sentinel: lane has no candidate

static_assert(TU == 4 * WARPS, "each warp scores 4 users");
static_assert(TC == 4 * 32, "each lane scores 4 items per chunk");
static_assert(SLOTS <= 32, "taken mask is one 32-bit word");

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
    return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(THREADS)
topk_block_kernel(const float* __restrict__ U, const float* __restrict__ I,
                  const int32_t* __restrict__ bitmap, int B, int N, int D,
                  int Dp, int W, int k, float* __restrict__ out_v,
                  int32_t* __restrict__ out_i) {
    extern __shared__ float smem[];
    float* S = smem;                 // [TU][TN] scores
    float* Us = S + TU * TN;         // [Dp][US_ROW] user tile, d-major
    float* Is = Us + Dp * US_ROW;    // [DK][IS_ROW] item slice, d-major

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int b0 = blockIdx.x * TU;
    const int blk = blockIdx.y;
    const int i_blk = blk * TN;

    for (int e = tid; e < TU * Dp; e += THREADS) {
        const int u = e / Dp, d = e % Dp;
        const int b = b0 + u;
        Us[d * US_ROW + u] = (b < B && d < D) ? U[(size_t)b * D + d] : 0.0f;
    }

    for (int c = 0; c < TN / TC; ++c) {
        const int i_chunk = i_blk + c * TC;
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[a][j] = 0.0f;

        for (int d0 = 0; d0 < Dp; d0 += DK) {
            __syncthreads();  // previous slice consumed (and Us written)
            for (int e = tid; e < TC * DK; e += THREADS) {
                const int it = e / DK, dd = e % DK;
                const int item = i_chunk + it, d = d0 + dd;
                Is[dd * IS_ROW + it] =
                    (item < N && d < D) ? I[(size_t)item * D + d] : 0.0f;
            }
            __syncthreads();
#pragma unroll 8
            for (int dd = 0; dd < DK; ++dd) {
                float iv[4], uv[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) iv[j] = Is[dd * IS_ROW + lane + 32 * j];
#pragma unroll
                for (int a = 0; a < 4; ++a) uv[a] = Us[(d0 + dd) * US_ROW + warp * 4 + a];
#pragma unroll
                for (int a = 0; a < 4; ++a)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[a][j] = fmaf(uv[a], iv[j], acc[a][j]);
            }
        }

#pragma unroll
        for (int a = 0; a < 4; ++a) {
            const int u = warp * 4 + a;
            const int b = b0 + u;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = c * TC + lane + 32 * j;
                const int item = i_blk + col;
                float v = acc[a][j];
                if (item >= N) {
                    v = -CUDART_INF_F;
                } else if (b < B) {
                    const uint32_t word =
                        (uint32_t)bitmap[(size_t)b * W + (item >> 5)];
                    if ((word >> (item & 31)) & 1u) v = NEG_INF;
                }
                S[u * TN + col] = v;
            }
        }
    }
    __syncthreads();

    // selection: warp w takes users w, w + WARPS, ...; lane owns the items
    // lane + 32 * s of the block (s < SLOTS)
    for (int u = warp; u < TU; u += WARPS) {
        const int b = b0 + u;
        if (b >= B) break;
        const float* row = S + u * TN;
        uint32_t taken = 0;
        float bv = -CUDART_INF_F;
        int bi = NO_IDX, bs = -1;
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
            const int idx = i_blk + lane + 32 * s;
            const float v = row[lane + 32 * s];
            if (better(v, idx, bv, bi)) { bv = v; bi = idx; bs = s; }
        }
        const size_t out_base = ((size_t)blk * B + b) * k;
        for (int r = 0; r < k; ++r) {
            float v = bv;
            int i = bi;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                const float ov = __shfl_xor_sync(0xffffffffu, v, off);
                const int oi = __shfl_xor_sync(0xffffffffu, i, off);
                if (better(ov, oi, v, i)) { v = ov; i = oi; }
            }
            if (lane == 0) {
                out_v[out_base + r] = v;
                out_i[out_base + r] = i;
            }
            if (i != NO_IDX && bi == i) {  // this lane owned the winner
                taken |= 1u << bs;
                bv = -CUDART_INF_F;
                bi = NO_IDX;
                bs = -1;
                for (int s = 0; s < SLOTS; ++s) {
                    if ((taken >> s) & 1u) continue;
                    const int idx = i_blk + lane + 32 * s;
                    const float sv = row[lane + 32 * s];
                    if (better(sv, idx, bv, bi)) { bv = sv; bi = idx; bs = s; }
                }
            }
        }
    }
}

}  // namespace

extern "C" {

int topk_block_items() { return TN; }

// Launches on `stream`; returns cudaGetLastError() (0 on success).
int topk_score_launch(const float* U, const float* I, const int32_t* bitmap,
                      int B, int N, int D, int W, int k, float* out_v,
                      int32_t* out_i, void* stream) {
    if (B <= 0 || N <= 0 || D <= 0 || k <= 0 || k > TN) {
        return (int)cudaErrorInvalidValue;
    }
    const int Dp = (D + DK - 1) / DK * DK;
    const size_t smem =
        sizeof(float) * ((size_t)TU * TN + (size_t)Dp * US_ROW + (size_t)DK * IS_ROW);
    cudaError_t err = cudaFuncSetAttribute(
        topk_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((B + TU - 1) / TU, (N + TN - 1) / TN);
    topk_block_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        U, I, bitmap, B, N, D, Dp, W, k, out_v, out_i);
    return (int)cudaGetLastError();
}

}  // extern "C"
