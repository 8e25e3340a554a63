// One CIN layer of xDeepFM, forward, with the Hadamard slab kept on chip:
//
//   conv[b, l, d] = relu( sum_{h,f} A[b,h,d] * B0[b,f,d] * W[h*F+f, l] + bias[l] )
//   hidden[b, l, d] = conv[b, l, d]                 for l <  nh
//   pooled[b, l - ps] = sum_d conv[b, l, d]         for l >= ps
//
// Replaces the Pallas TPU kernels of oovrec_tpu/ops/cin_fused.py:
// `_pooled_fwd_call` (body `_make_pooled_fwd`, pallas_call at :368) and,
// with nh = L and no pooled rows, `_fwd_call` (body `_make_fwd_kernel`,
// pallas_call at :129). It computes the same function; the layout and the
// blocking are Hopper's own. The TPU kernels ride a batch-minor (H, D, B)
// layout for its 128 lanes; here every tensor is batch-major and row-major,
// A (B, H, D), B0 (B, F, D), hidden (B, nh, D), pooled (B, L - ps), so the
// model's (B, F, D) embeddings go in as they are and the next layer reads
// `hidden` without a transpose.
//
// It is a matrix product Z (B*D x H*F) @ W (H*F x L), where row m = (b, d)
// of Z is the pair vector z[h*F+f] = A[b,h,d] * B0[b,f,d]. One block owns
// TB = TM / D whole batch rows (TM = 128 rows of Z, all of D) and TL = 64
// columns of W:
//   1. the pair axis is walked in chunks of KC: the block forms its
//      KC x TM slice of Z in shared memory from A and B0 (the slab never
//      reaches device memory) and stages the KC x TL slice of W beside it,
//      so W of any size (F = 39: 1950 x 100, 780 KB) streams through;
//   2. each thread accumulates an 8 x 4 register tile in f32, a plain FMA
//      loop over the pair axis in ascending order (no TF32);
//   3. the epilogue adds bias, applies ReLU into a shared tile, writes the
//      hidden rows and sums each pooled row over D in ascending d inside
//      the block. No atomics: the result is deterministic and equals a
//      plain f32 product bit for bit wherever every sum is exact.
// With `bf16` set, A, B0 and W are rounded to bf16 first, then each product
// A*B0 is rounded to bf16, then multiplied by W with f32 accumulation: the
// order of `_make_pooled_fwd` (:263-269). I/O stays f32 in both modes.
//
// Bound at the serving shapes (B = 8192, D = 10, F = 7, L = 100, pair axes
// 49, 350, 350): 2*B*D*HF*L = 12.3 GFLOP of f32 FMA per 3-layer forward
// (0.18 ms at 67 TFLOP/s) against about 35 MB per wide layer (0.01 ms at
// 3.35 TB/s), so it is bound by operations. This first version is simple
// and right: tensor-core (wgmma) tiles and a pair chunk held in registers
// come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TM = 128;         // rows (b, d) of Z per block
constexpr int TL = 64;          // columns of W per block
constexpr int KC = 32;          // pair-axis chunk
constexpr int RM = 8;           // rows per thread
constexpr int RN = 4;           // columns per thread
constexpr int S_ROW = TL + 1;   // padded rows of the output tile

static_assert((TM / RM) * (TL / RN) == THREADS, "one register tile per thread");
static_assert(THREADS % TM == 0, "each thread forms Z for one fixed row");
static_assert(THREADS % TL == 0, "each thread stages W for one fixed column");

constexpr size_t SMEM_BYTES =
    sizeof(float) * ((size_t)KC * TM + (size_t)KC * TL + (size_t)TM * S_ROW);

__device__ __forceinline__ float to_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
cin_fused_kernel(const float* __restrict__ A, const float* __restrict__ B0,
                 const float* __restrict__ W, const float* __restrict__ bias,
                 int B, int H, int F, int D, int L, int TB, int nh, int ps,
                 float* __restrict__ hidden, float* __restrict__ pooled) {
    extern __shared__ __align__(16) float smem[];
    float* Zs = smem;              // [KC][TM]  pair slice of Z, k-major
    float* Ws = Zs + KC * TM;      // [KC][TL]  slice of W
    float* S = Ws + KC * TL;       // [TM][S_ROW] relu(conv) tile

    const int tid = threadIdx.x;
    const int tx = tid % (TL / RN);  // column group
    const int ty = tid / (TL / RN);  // row group
    const int b0 = blockIdx.x * TB;
    const int l0 = blockIdx.y * TL;
    const int HF = H * F;
    const int Lp = L - ps;

    // the one row of Z this thread forms in every chunk
    const int zm = tid % TM;
    const int zk0 = tid / TM;
    const int zb = b0 + zm / D;
    const bool z_row = zm < TB * D && zb < B;
    const float* a_row = A + ((size_t)(z_row ? zb : 0) * H) * D + zm % D;
    const float* c_row = B0 + ((size_t)(z_row ? zb : 0) * F) * D + zm % D;
    // the one column of W this thread stages
    const int wc = tid % TL;
    const int wk0 = tid / TL;
    const bool w_col = l0 + wc < L;

    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < HF; k0 += KC) {
        __syncthreads();  // the previous chunk is consumed
        for (int k = zk0; k < KC; k += THREADS / TM) {
            const int hf = k0 + k;
            float z = 0.0f;
            if (z_row && hf < HF) {
                const int h = hf / F;
                const int f = hf - h * F;
                float a = a_row[(size_t)h * D];
                float c = c_row[(size_t)f * D];
                if (BF16) {
                    a = to_bf16(a);
                    c = to_bf16(c);
                    z = to_bf16(a * c);
                } else {
                    z = a * c;
                }
            }
            Zs[k * TM + zm] = z;
        }
        for (int k = wk0; k < KC; k += THREADS / TL) {
            const int hf = k0 + k;
            float w = (w_col && hf < HF) ? W[(size_t)hf * L + l0 + wc] : 0.0f;
            Ws[k * TL + wc] = BF16 ? to_bf16(w) : w;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < KC; ++k) {
            const float4 z0 = *reinterpret_cast<const float4*>(&Zs[k * TM + ty * RM]);
            const float4 z1 = *reinterpret_cast<const float4*>(&Zs[k * TM + ty * RM + 4]);
            const float4 w4 = *reinterpret_cast<const float4*>(&Ws[k * TL + tx * RN]);
            const float zr[RM] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
            const float wr[RN] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
                for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(zr[i], wr[j], acc[i][j]);
        }
    }

    // epilogue: bias + relu into the shared tile
#pragma unroll
    for (int j = 0; j < RN; ++j) {
        const int c = tx * RN + j;
        const float bj = (l0 + c < L) ? bias[l0 + c] : 0.0f;
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            S[(ty * RM + i) * S_ROW + c] = fmaxf(acc[i][j] + bj, 0.0f);
        }
    }
    __syncthreads();

    const int n_cols = min(TL, L - l0);
    // hidden rows l < nh: for each batch row a contiguous run of (l, d)
    const int nh_cols = max(0, min(n_cols, nh - l0));
    if (nh_cols > 0) {
        const int per_b = nh_cols * D;
        for (int e = tid; e < TB * per_b; e += THREADS) {
            const int bl = e / per_b;
            const int r = e - bl * per_b;
            const int c = r / D;
            const int d = r - c * D;
            const int b = b0 + bl;
            if (b < B) {
                hidden[((size_t)b * nh + l0 + c) * D + d] = S[(bl * D + d) * S_ROW + c];
            }
        }
    }
    // pooled rows l >= ps: sum over d in ascending order
    const int cp0 = max(0, ps - l0);
    const int np_cols = n_cols - cp0;
    if (np_cols > 0) {
        for (int e = tid; e < TB * np_cols; e += THREADS) {
            const int bl = e / np_cols;
            const int c = cp0 + (e - bl * np_cols);
            const int b = b0 + bl;
            if (b < B) {
                float s = 0.0f;
                for (int d = 0; d < D; ++d) s += S[(bl * D + d) * S_ROW + c];
                pooled[(size_t)b * Lp + (l0 + c - ps)] = s;
            }
        }
    }
}

template <bool BF16>
int launch(const float* A, const float* B0, const float* W, const float* bias,
           int B, int H, int F, int D, int L, int nh, int ps, float* hidden,
           float* pooled, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        cin_fused_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const int TB = TM / D;
    const dim3 grid((B + TB - 1) / TB, (L + TL - 1) / TL);
    cin_fused_kernel<BF16><<<grid, THREADS, SMEM_BYTES, stream>>>(
        A, B0, W, bias, B, H, F, D, L, TB, nh, ps, hidden, pooled);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cin_fused_max_depth() { return TM; }

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// hidden (B, nh, D) may be null when nh == 0, pooled (B, L - ps) when ps == L.
int cin_fused_launch(const float* A, const float* B0, const float* W,
                     const float* bias, int B, int H, int F, int D, int L,
                     int nh, int ps, int bf16, float* hidden, float* pooled,
                     void* stream) {
    if (B <= 0 || H <= 0 || F <= 0 || D <= 0 || D > TM || L <= 0 || nh < 0 ||
        nh > L || ps < 0 || ps > L || (nh > 0 && hidden == nullptr) ||
        (ps < L && pooled == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    if (bf16) {
        return launch<true>(A, B0, W, bias, B, H, F, D, L, nh, ps, hidden,
                            pooled, (cudaStream_t)stream);
    }
    return launch<false>(A, B0, W, bias, B, H, F, D, L, nh, ps, hidden, pooled,
                         (cudaStream_t)stream);
}

}  // extern "C"
