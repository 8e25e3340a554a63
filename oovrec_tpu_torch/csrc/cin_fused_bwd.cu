// One CIN layer of xDeepFM, backward (the VJP of csrc/cin_fused.cu):
//
//   pre[b, l, d]  = sum_{h,f} A[b,h,d] * B0[b,f,d] * W[h*F+f, l] + bias[l]
//   g[b, l, d]    = (l <  nh ? gh[b, l, d]    : 0)
//                 + (l >= ps ? gp[b, l - ps]  : 0)      (pooled rows: dsum over d)
//   dpre          = pre > 0 ? g : 0                     (0 at pre == 0)
//   dW[k, l]      = sum_{b,d} z[b,k,d] * dpre[b,l,d]     z[b,h*F+f,d] = A*B0
//   dbias[l]      = sum_{b,d} dpre[b,l,d]
//   dz[b, k, d]   = sum_l W[k,l] * dpre[b,l,d]
//   dA[b, h, d]   = sum_f dz[b,h*F+f,d] * B0[b,f,d]
//   dB0[b, f, d]  = sum_h dz[b,h*F+f,d] * A[b,h,d]
//
// Replaces the Pallas TPU kernels of oovrec_tpu/ops/cin_fused.py:
// `_pooled_bwd_call` (body `_make_pooled_bwd`, pallas_call at :414) and,
// with nh = L and no pooled rows, `_bwd_call` (body `_make_bwd_kernel`,
// pallas_call at :155). The three layer modes of :316-324 are the cases of
// g above: direct (nh = L, ps = 0: gh + gp on every row), mid layer
// (ps = nh: gh above, gp below), last layer (nh = 0, ps = 0: gp only). A
// null gh or gp is a zero gradient. Layout as in the forward: batch-major,
// row-major A (B, H, D), B0 (B, F, D), gh (B, nh, D), gp (B, L - ps).
//
// The TPU kernel sums dW and dbias across a grid that runs in order. Hopper
// blocks run in parallel, so the work is four launches on one stream, with
// no atomics (the result does not depend on the launch):
//   1. dpre: the forward's blocking (TB whole batch rows x 64 columns of W)
//      recomputes pre from A, B0 and W (the Hadamard slab stays in shared
//      memory), masks g and writes dpre (B*D, L) f32 to the workspace;
//   2. dW partials: block (k tile, l tile, s) owns a 128 x 64 tile of dW
//      and walks its slice s of the B*D rows in ascending order, forming z
//      from A and B0 in shared memory; the l-tile's k = 0 blocks also sum
//      dpre's columns for dbias over the same rows;
//   3. reduce: dW and dbias sum the slices' partials in ascending s;
//   4. dA / dB0: a block owns 64 rows (b, d), holds their dpre in shared
//      memory, forms dz = dpre W^T one 64-column tile of the pair axis at a
//      time in registers and contracts each tile into dA and dB0
//      accumulators in shared memory (ascending h, f).
// All sums are f32 FMAs in a fixed order: on integer-valued inputs the
// result equals the plain version bit for bit, and it is the same on every
// run. With `bf16` set, A, B0 and W are rounded to bf16, then each A*B0
// product, and dpre is rounded to bf16 before both products (dW and dz);
// dbias sums the unrounded dpre, and dA / dB0 contract dz in f32 against
// the rounded B0 / A: the order of `_make_pooled_bwd` (:304-343).
//
// Bound at the training shapes (B = 8192, D = 10, F = 7, L = 100, pair axes
// 49, 350, 350): three products of 2*B*D*HF*L operations per layer, 37 GFLOP
// per 3-layer backward, 0.55 ms at 67 TFLOP/s f32, against about 70 MB
// moved per wide layer (0.02 ms at 3.35 TB/s): bound by operations. This
// first version is simple and right: plain FMAs on CUDA cores; tensor-core
// tiles and fusing the four launches come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// launches 1 and 2: a 128 x 64 tile, 8 x 4 registers per thread
constexpr int TM = 128;
constexpr int TL = 64;
constexpr int KC = 32;   // reduction chunk
constexpr int RM = 8;
constexpr int RN = 4;
constexpr int S_ROW = TL + 1;
// launch 4: 64 rows x 64 pair columns, 4 x 4 registers per thread
constexpr int DM = 64;
constexpr int DK = 64;
constexpr int DR = 4;
constexpr int DSTR = DM + 4;     // padded stride of the transposed tiles
constexpr int SZ_ROW = DK + 1;
// launch 2: aim for four waves of blocks on 132 SMs
constexpr int TARGET_BLOCKS = 4 * 132;
constexpr int MAX_SMEM = 232448;

static_assert((TM / RM) * (TL / RN) == THREADS, "one register tile per thread");
static_assert((DM / DR) * (DK / DR) == THREADS, "one register tile per thread");
static_assert(THREADS % TM == 0 && THREADS % TL == 0, "fixed staging columns");

constexpr size_t DPRE_SMEM =
    sizeof(float) * ((size_t)KC * TM + (size_t)KC * TL + (size_t)TM * S_ROW);
constexpr size_t DW_SMEM =
    sizeof(float) * ((size_t)KC * TM + (size_t)KC * TL + (size_t)THREADS);

size_t dadb_smem(int H, int F, int L) {
    return sizeof(float) * (2 * (size_t)L * DSTR + (size_t)DM * SZ_ROW +
                            (size_t)DM * (H + F));
}

__device__ __forceinline__ float to_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// How launch 2 splits the B*D rows: S slices of MS rows (a multiple of KC).
struct Split {
    int S;
    int MS;
};

Split split_rows(long long M, int HF, int L) {
    const long long tiles = (long long)((HF + TM - 1) / TM) * ((L + TL - 1) / TL);
    long long S = (TARGET_BLOCKS + tiles - 1) / tiles;
    const long long max_s = (M + KC - 1) / KC;
    if (S > max_s) S = max_s;
    if (S < 1) S = 1;
    long long MS = (M + S - 1) / S;
    MS = (MS + KC - 1) / KC * KC;
    S = (M + MS - 1) / MS;
    return Split{(int)S, (int)MS};
}

// ---------------------------------------------------------------- launch 1

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
cin_bwd_dpre_kernel(const float* __restrict__ A, const float* __restrict__ B0,
                    const float* __restrict__ W, const float* __restrict__ bias,
                    const float* __restrict__ gh, const float* __restrict__ gp,
                    int B, int H, int F, int D, int L, int TB, int nh, int ps,
                    float* __restrict__ dpre) {
    extern __shared__ __align__(16) float smem[];
    float* Zs = smem;              // [KC][TM]  pair slice of Z, k-major
    float* Ws = Zs + KC * TM;      // [KC][TL]  slice of W
    float* S = Ws + KC * TL;       // [TM][S_ROW] pre tile

    const int tid = threadIdx.x;
    const int tx = tid % (TL / RN);
    const int ty = tid / (TL / RN);
    const int b0 = blockIdx.x * TB;
    const int l0 = blockIdx.y * TL;
    const int HF = H * F;
    const int Lp = L - ps;

    const int zm = tid % TM;
    const int zk0 = tid / TM;
    const int zb = b0 + zm / D;
    const bool z_row = zm < TB * D && zb < B;
    const float* a_row = A + ((size_t)(z_row ? zb : 0) * H) * D + zm % D;
    const float* c_row = B0 + ((size_t)(z_row ? zb : 0) * F) * D + zm % D;
    const int wc = tid % TL;
    const int wk0 = tid / TL;
    const bool w_col = l0 + wc < L;

    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < HF; k0 += KC) {
        __syncthreads();
        for (int k = zk0; k < KC; k += THREADS / TM) {
            const int hf = k0 + k;
            float z = 0.0f;
            if (z_row && hf < HF) {
                const int h = hf / F;
                const int f = hf - h * F;
                float a = a_row[(size_t)h * D];
                float c = c_row[(size_t)f * D];
                if (BF16) {
                    z = to_bf16(to_bf16(a) * to_bf16(c));
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

#pragma unroll
    for (int j = 0; j < RN; ++j) {
        const int c = tx * RN + j;
        const float bj = (l0 + c < L) ? bias[l0 + c] : 0.0f;
#pragma unroll
        for (int i = 0; i < RM; ++i) S[(ty * RM + i) * S_ROW + c] = acc[i][j] + bj;
    }
    __syncthreads();

    // dpre rows m = b * D + d of this block, columns l0 .. l0 + n_cols
    const int n_cols = min(TL, L - l0);
    const int rows = min(TB, B - b0) * D;
    const size_t m0 = (size_t)b0 * D;
    for (int e = tid; e < rows * n_cols; e += THREADS) {
        const int r = e / n_cols;
        const int c = e - r * n_cols;
        const int b = b0 + r / D;
        const int d = r % D;
        const int l = l0 + c;
        float g = 0.0f;
        if (gh != nullptr && l < nh) g = gh[((size_t)b * nh + l) * D + d];
        if (gp != nullptr && l >= ps) g += gp[(size_t)b * Lp + (l - ps)];
        dpre[(m0 + r) * L + l] = S[r * S_ROW + c] > 0.0f ? g : 0.0f;
    }
}

// ---------------------------------------------------------------- launch 2

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
cin_bwd_dw_kernel(const float* __restrict__ A, const float* __restrict__ B0,
                  const float* __restrict__ dpre, int H, int F, int D, int L,
                  long long M, int MS, float* __restrict__ part_w,
                  float* __restrict__ part_b) {
    extern __shared__ __align__(16) float smem[];
    float* Zs = smem;              // [KC][TM]  z rows m, columns k
    float* Ds = Zs + KC * TM;      // [KC][TL]  dpre rows m, columns l
    float* red = Ds + KC * TL;     // [THREADS / TL][TL] dbias partials

    const int tid = threadIdx.x;
    const int tx = tid % (TL / RN);
    const int ty = tid / (TL / RN);
    const int k0 = blockIdx.x * TM;
    const int l0 = blockIdx.y * TL;
    const int s = blockIdx.z;
    const int HF = H * F;
    const long long m_beg = (long long)s * MS;
    const long long m_end = min(M, m_beg + MS);
    const bool do_bias = blockIdx.x == 0;

    // the one column k of z this thread forms
    const int zk = tid % TM;
    const int zm0 = tid / TM;
    const bool z_col = k0 + zk < HF;
    const int h = z_col ? (k0 + zk) / F : 0;
    const int f = z_col ? (k0 + zk) - h * F : 0;
    // the one column l of dpre this thread stages
    const int wc = tid % TL;
    const int wm0 = tid / TL;
    const bool w_col = l0 + wc < L;

    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;
    float bsum = 0.0f;

    for (long long mc = m_beg; mc < m_end; mc += KC) {
        __syncthreads();
        for (int mm = zm0; mm < KC; mm += THREADS / TM) {
            const long long m = mc + mm;
            float z = 0.0f;
            if (z_col && m < m_end) {
                const long long b = m / D;
                const int d = (int)(m - b * D);
                float a = A[((size_t)b * H + h) * D + d];
                float c = B0[((size_t)b * F + f) * D + d];
                if (BF16) {
                    z = to_bf16(to_bf16(a) * to_bf16(c));
                } else {
                    z = a * c;
                }
            }
            Zs[mm * TM + zk] = z;
        }
        for (int mm = wm0; mm < KC; mm += THREADS / TL) {
            const long long m = mc + mm;
            const float v = (w_col && m < m_end) ? dpre[(size_t)m * L + l0 + wc] : 0.0f;
            bsum += v;
            Ds[mm * TL + wc] = BF16 ? to_bf16(v) : v;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < KC; ++k) {
            const float4 z0 = *reinterpret_cast<const float4*>(&Zs[k * TM + ty * RM]);
            const float4 z1 = *reinterpret_cast<const float4*>(&Zs[k * TM + ty * RM + 4]);
            const float4 w4 = *reinterpret_cast<const float4*>(&Ds[k * TL + tx * RN]);
            const float zr[RM] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
            const float wr[RN] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
                for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(zr[i], wr[j], acc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int k = k0 + ty * RM + i;
#pragma unroll
        for (int j = 0; j < RN; ++j) {
            const int l = l0 + tx * RN + j;
            if (k < HF && l < L) part_w[((size_t)s * HF + k) * L + l] = acc[i][j];
        }
    }
    if (do_bias) {  // uniform across the block
        red[wm0 * TL + wc] = bsum;
        __syncthreads();
        if (tid < TL && l0 + tid < L) {
            float t = 0.0f;
            for (int g = 0; g < THREADS / TL; ++g) t += red[g * TL + tid];
            part_b[(size_t)s * L + l0 + tid] = t;
        }
    }
}

// ---------------------------------------------------------------- launch 3

__global__ void cin_bwd_reduce_kernel(const float* __restrict__ part_w,
                                      const float* __restrict__ part_b, int S,
                                      int n_w, int L, float* __restrict__ dW,
                                      float* __restrict__ dbias) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n_w) {
        float t = 0.0f;
        for (int s = 0; s < S; ++s) t += part_w[(size_t)s * n_w + i];
        dW[i] = t;
    } else if (i < n_w + L) {
        const int l = i - n_w;
        float t = 0.0f;
        for (int s = 0; s < S; ++s) t += part_b[(size_t)s * L + l];
        dbias[l] = t;
    }
}

// ---------------------------------------------------------------- launch 4

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
cin_bwd_dadb_kernel(const float* __restrict__ A, const float* __restrict__ B0,
                    const float* __restrict__ W, const float* __restrict__ dpre,
                    int H, int F, int D, int L, long long M,
                    float* __restrict__ dA, float* __restrict__ dB0) {
    extern __shared__ __align__(16) float smem[];
    float* Dt = smem;                    // [L][DSTR] dpre of the block's rows
    float* Wt = Dt + (size_t)L * DSTR;   // [L][DSTR] one tile of W^T
    float* Sz = Wt + (size_t)L * DSTR;   // [DM][SZ_ROW] dz tile
    float* dA_s = Sz + DM * SZ_ROW;      // [DM][H]
    float* dB0_s = dA_s + DM * H;        // [DM][F]

    const int tid = threadIdx.x;
    const int tx = tid % (DK / DR);
    const int ty = tid / (DK / DR);
    const long long m0 = (long long)blockIdx.x * DM;
    const int HF = H * F;

    for (int e = tid; e < DM * (H + F); e += THREADS) dA_s[e] = 0.0f;
    for (int e = tid; e < DM * L; e += THREADS) {
        const int mm = e / L;
        const int l = e - mm * L;
        const long long m = m0 + mm;
        const float v = m < M ? dpre[(size_t)m * L + l] : 0.0f;
        Dt[l * DSTR + mm] = BF16 ? to_bf16(v) : v;
    }

    for (int k0 = 0; k0 < HF; k0 += DK) {
        __syncthreads();  // the previous tile is consumed
        for (int e = tid; e < DK * L; e += THREADS) {
            const int kk = e / L;
            const int l = e - kk * L;
            const int k = k0 + kk;
            const float w = k < HF ? W[(size_t)k * L + l] : 0.0f;
            Wt[l * DSTR + kk] = BF16 ? to_bf16(w) : w;
        }
        __syncthreads();
        float acc[DR][DR];
#pragma unroll
        for (int i = 0; i < DR; ++i)
#pragma unroll
            for (int j = 0; j < DR; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
        for (int l = 0; l < L; ++l) {
            const float4 p = *reinterpret_cast<const float4*>(&Dt[l * DSTR + ty * DR]);
            const float4 w = *reinterpret_cast<const float4*>(&Wt[l * DSTR + tx * DR]);
            const float pr[DR] = {p.x, p.y, p.z, p.w};
            const float wr[DR] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int i = 0; i < DR; ++i)
#pragma unroll
                for (int j = 0; j < DR; ++j) acc[i][j] = fmaf(pr[i], wr[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < DR; ++i)
#pragma unroll
            for (int j = 0; j < DR; ++j) Sz[(ty * DR + i) * SZ_ROW + tx * DR + j] = acc[i][j];
        __syncthreads();

        // contract the tile: pair columns k0 .. k_hi - 1 are (h, f) with
        // h in [h_lo, h_hi]; each (row, h) and (row, f) has one owner
        const int k_hi = min(k0 + DK, HF);
        const int h_lo = k0 / F;
        const int h_hi = (k_hi - 1) / F;
        const int nht = h_hi - h_lo + 1;
        for (int e = tid; e < nht * DM; e += THREADS) {
            const int hh = e / DM;
            const int mm = e - hh * DM;
            const long long m = m0 + mm;
            if (m >= M) continue;
            const long long b = m / D;
            const int d = (int)(m - b * D);
            const int h = h_lo + hh;
            const int f_beg = max(0, k0 - h * F);
            const int f_end = min(F, k_hi - h * F);
            float s = 0.0f;
            for (int f = f_beg; f < f_end; ++f) {
                float c = B0[((size_t)b * F + f) * D + d];
                if (BF16) c = to_bf16(c);
                s = fmaf(Sz[mm * SZ_ROW + h * F + f - k0], c, s);
            }
            dA_s[mm * H + h] += s;
        }
        for (int e = tid; e < F * DM; e += THREADS) {
            const int f = e / DM;
            const int mm = e - f * DM;
            const long long m = m0 + mm;
            if (m >= M) continue;
            const long long b = m / D;
            const int d = (int)(m - b * D);
            float s = 0.0f;
            for (int h = h_lo; h <= h_hi; ++h) {
                const int k = h * F + f;
                if (k < k0 || k >= k_hi) continue;
                float a = A[((size_t)b * H + h) * D + d];
                if (BF16) a = to_bf16(a);
                s = fmaf(Sz[mm * SZ_ROW + k - k0], a, s);
            }
            dB0_s[mm * F + f] += s;
        }
    }
    __syncthreads();

    for (int e = tid; e < DM * H; e += THREADS) {
        const int h = e / DM;
        const int mm = e - h * DM;
        const long long m = m0 + mm;
        if (m >= M) continue;
        const long long b = m / D;
        const int d = (int)(m - b * D);
        dA[((size_t)b * H + h) * D + d] = dA_s[mm * H + h];
    }
    for (int e = tid; e < DM * F; e += THREADS) {
        const int f = e / DM;
        const int mm = e - f * DM;
        const long long m = m0 + mm;
        if (m >= M) continue;
        const long long b = m / D;
        const int d = (int)(m - b * D);
        dB0[((size_t)b * F + f) * D + d] = dB0_s[mm * F + f];
    }
}

// ---------------------------------------------------------------- host

template <bool BF16>
int launch(const float* A, const float* B0, const float* W, const float* bias,
           const float* gh, const float* gp, int B, int H, int F, int D, int L,
           int nh, int ps, float* dA, float* dB0, float* dW, float* dbias,
           float* work, cudaStream_t stream) {
    const long long M = (long long)B * D;
    const int HF = H * F;
    const Split sp = split_rows(M, HF, L);
    float* dpre = work;
    float* part_w = dpre + (size_t)M * L;
    float* part_b = part_w + (size_t)sp.S * HF * L;
    const size_t smem4 = dadb_smem(H, F, L);

    cudaError_t err = cudaFuncSetAttribute(
        cin_bwd_dpre_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)DPRE_SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(cin_bwd_dadb_kernel<BF16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem4);
    if (err != cudaSuccess) return (int)err;

    const int TB = TM / D;
    cin_bwd_dpre_kernel<BF16><<<dim3((B + TB - 1) / TB, (L + TL - 1) / TL),
                                THREADS, DPRE_SMEM, stream>>>(
        A, B0, W, bias, gh, gp, B, H, F, D, L, TB, nh, ps, dpre);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    cin_bwd_dw_kernel<BF16><<<dim3((HF + TM - 1) / TM, (L + TL - 1) / TL, sp.S),
                              THREADS, DW_SMEM, stream>>>(
        A, B0, dpre, H, F, D, L, M, sp.MS, part_w, part_b);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const int n_w = HF * L;
    cin_bwd_reduce_kernel<<<(n_w + L + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        part_w, part_b, sp.S, n_w, L, dW, dbias);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    cin_bwd_dadb_kernel<BF16><<<(unsigned)((M + DM - 1) / DM), THREADS, smem4, stream>>>(
        A, B0, W, dpre, H, F, D, L, M, dA, dB0);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cin_bwd_max_depth() { return TM; }

// Shared memory of launch 4 (bytes); the wrapper refuses shapes above
// cin_bwd_max_smem().
long long cin_bwd_smem_bytes(int H, int F, int L) { return (long long)dadb_smem(H, F, L); }

long long cin_bwd_max_smem() { return MAX_SMEM; }

// f32 elements of the workspace: dpre (B*D, L) and the dW / dbias partials.
long long cin_bwd_workspace_floats(int B, int H, int F, int D, int L) {
    const long long M = (long long)B * D;
    const Split sp = split_rows(M, H * F, L);
    return M * L + (long long)sp.S * H * F * L + (long long)sp.S * L;
}

// Launches on `stream`; returns the first cudaError_t (0 on success).
// gh (B, nh, D) and gp (B, L - ps) may be null: a zero gradient.
int cin_bwd_launch(const float* A, const float* B0, const float* W,
                   const float* bias, const float* gh, const float* gp, int B,
                   int H, int F, int D, int L, int nh, int ps, int bf16,
                   float* dA, float* dB0, float* dW, float* dbias, float* work,
                   void* stream) {
    if (B <= 0 || H <= 0 || F <= 0 || D <= 0 || D > TM || L <= 0 || nh < 0 ||
        nh > L || ps < 0 || ps > L || dadb_smem(H, F, L) > (size_t)MAX_SMEM) {
        return (int)cudaErrorInvalidValue;
    }
    if (bf16) {
        return launch<true>(A, B0, W, bias, gh, gp, B, H, F, D, L, nh, ps, dA,
                            dB0, dW, dbias, work, (cudaStream_t)stream);
    }
    return launch<false>(A, B0, W, bias, gh, gp, B, H, F, D, L, nh, ps, dA, dB0,
                         dW, dbias, work, (cudaStream_t)stream);
}

}  // extern "C"
