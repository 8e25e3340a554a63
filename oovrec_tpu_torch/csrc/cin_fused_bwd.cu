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
// What bounds it on the H100 (B = 8192, D = 10, F = 7, L = 100, pair axes
// 49, 350, 350): three products of 2*B*D*HF*L operations per layer, 37 GFLOP
// per 3-layer backward, 0.55 ms at 67 TFLOP/s f32, against about 70 MB
// moved per wide layer (0.02 ms at 3.35 TB/s): operations. So the time
// must go to FMAs, not to rebuilding z, 64-bit index math or round trips
// of dpre through device memory. Three launches on one stream, no atomics:
//   1. rows: a block owns `tb` whole batch rows (tb * D <= 128 rows (b, d))
//      and loads their A and B0 into shared memory once. It forms z chunks
//      of 32 pair columns from those tiles (offsets from a per-block table,
//      32-bit, no division in the loop), computes pre for all L columns in
//      one pass (each thread 8 rows x RN columns, RN = ceil(L / 16) rounded
//      to 2 / 4 / 7 / 8: 112 columns at L = 100), applies bias and mask and
//      keeps dpre in shared memory; dpre goes to device memory once, for
//      launch 2. It then forms dz = dpre W^T for whole h groups of the pair
//      axis (64 columns a sub-tile, 8 x 4 registers a thread, W rows read
//      as float4 along l, four l a step) and contracts it against the B0
//      and A tiles already in shared memory: dA is complete per group and
//      written out, dB0 adds each group's partial sum in shared memory in
//      ascending h. One block of 8 warps fills an SM, so latency is hidden
//      by instruction-level parallelism, not by other warps: W reaches
//      shared memory as rows by 16-byte cp.async (each block reads W twice
//      from L2, about 300 KB at the published widths), and the z staging
//      and the contraction keep several independent loads and sums in
//      flight (each sum still in its fixed order).
//   2. dW / dbias partials: block (k tile of 128 pair columns, slice s)
//      walks its slice of the B*D rows in ascending order in chunks of 32,
//      forming z from A and B0 (one lane a row, coalesced, the (b, d) of the
//      row advanced without division), each thread 8 pair columns x RN
//      columns of dW; the k = 0 blocks also sum dpre for dbias.
//   3. reduce: dW and dbias sum the slices' partials in ascending s.
// The wrapper computes the geometry (tb, the slice length, the slices, the
// workspace) in Python and passes it in; this file checks it. A layer
// wider than one launch (L > 128, D > 128, or rows beyond shared memory) is
// launched by the wrapper over groups of at most 128 columns and spans of D
// (`ops/cin_fused.py:bwd_plan`): a group needs only its own columns of W,
// bias and the gradient, and its dz is one part of the sum over l, so dA
// and dB0 add the groups' parts.
// All sums are f32 FMAs in a fixed order: on integer-valued inputs the
// result equals the plain version bit for bit, and it is the same on every
// run. With `bf16` set, A, B0 and W are rounded to bf16, then each A*B0
// product, and dpre is rounded to bf16 before both products (dW and dz);
// dbias sums the unrounded dpre, and dA / dB0 contract dz in f32 against
// the rounded B0 / A: the order of `_make_pooled_bwd` (:304-343).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 128;       // launch 1: (b, d) rows per block at most
constexpr int TMS = ROWS + 4;   // padded stride of the row-minor tiles
constexpr int KC = 32;          // launch 1: pair chunk; launch 2: row chunk
constexpr int DZ = 64;          // launch 1: dz columns per sub-tile
constexpr int DW_TILE = 128;    // launch 2: pair columns per block
constexpr int MAX_L = 128;
constexpr int MAX_SMEM = 232448;

__host__ __device__ constexpr int a4(int n) { return (n + 3) / 4 * 4; }

__host__ __device__ inline int rn_of(int L) {
    const int c = (L + 15) / 16;
    return c <= 2 ? 2 : c <= 4 ? 4 : c <= 7 ? 7 : 8;
}

// launch 1: pair columns of one h group, its padded width, dz row stride
__host__ __device__ inline int group_cols(int F) { return (F < DZ ? DZ / F : 1) * F; }
__host__ __device__ inline int group_pad(int F) { return (group_cols(F) + DZ - 1) / DZ * DZ; }
__host__ __device__ inline int dz_stride(int F) { return (group_cols(F) + 1) | 1; }
// W rows in shared memory: float4 rows whose pitch / 4 is odd, so the
// eight rows a quarter-warp reads fall in distinct banks
__host__ __device__ inline int w_pitch(int L) { return a4(L) / 4 % 2 ? a4(L) : a4(L) + 4; }

// launch 1's shared memory, in floats: the pre phase (a z chunk and two W
// chunks) and the dz phase (the W rows of two h groups and the dz tile)
// share a region
__host__ __device__ inline size_t phase_floats(int F, int L) {
    const size_t a = (size_t)KC * TMS + 2 * (size_t)KC * 16 * rn_of(L);
    const size_t b = 2 * (size_t)group_pad(F) * w_pitch(L) + a4(ROWS * dz_stride(F));
    return a > b ? a : b;
}

size_t row_smem(int tb, int H, int F, int D, int L) {
    return 4 * ((size_t)a4(tb * H * D) + a4(tb * F * D) + (size_t)L * TMS + a4(tb * L) +
                a4(L) + phase_floats(F, L) + a4(ROWS * F) + a4(H * F));
}

__device__ __forceinline__ float to_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
    return BF16 ? to_bf16(x) : x;
}

// 4 or 16 bytes from device to shared memory without a register; 0 bytes
// fills zeros
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes = 4) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(bytes) : "memory");
}

__device__ __forceinline__ void round4(float* p) {
    for (int q = 0; q < 4; ++q) p[q] = to_bf16(p[q]);
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- launch 1

template <bool BF16, int RN>
__global__ void __launch_bounds__(THREADS, 1)
cin_bwd_rows_kernel(const float* __restrict__ A, const float* __restrict__ B0,
                    const float* __restrict__ W, const float* __restrict__ bias,
                    const float* __restrict__ gh, const float* __restrict__ gp, int B,
                    int H, int F, int D, int L, int tb, int nh, int ps,
                    float* __restrict__ dpre, float* __restrict__ dA,
                    float* __restrict__ dB0) {
    constexpr int LP = 16 * RN;
    extern __shared__ __align__(16) float smem[];
    const int HF = H * F;
    const int kc2 = group_cols(F), hc = kc2 / F, kc2p = group_pad(F);
    const int wp = w_pitch(L), szs = dz_stride(F);
    // 16-byte copies of W rows where they are aligned
    const bool vec = (L & 3) == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0;
    const int Lp = L - ps;
    float* As = smem;                             // [tb][H][D]
    float* Bs = As + a4(tb * H * D);              // [tb][F][D]
    float* Dt = Bs + a4(tb * F * D);              // [L][TMS] gh, then dpre; l-major
    float* Gp = Dt + L * TMS;                     // [tb][L - ps]
    float* Bias = Gp + a4(tb * L);                // [L]
    float* Zs = Bias + a4(L);                     // phase A: [KC][TMS] z chunk
    float* Ws = Zs + KC * TMS;                    //          [2][KC][LP] W chunks
    float* Wg = Zs;                               // phase B: [2][kc2p][wp] W rows of a group
    float* Sz = Wg + 2 * kc2p * wp;               //          [ROWS][szs] dz
    float* dB0s = Zs + phase_floats(F, L);        // [ROWS][F]
    int* koff = reinterpret_cast<int*>(dB0s + a4(ROWS * F));  // [HF]

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int lane = tid & 31, warp = tid >> 5;
    const int b0 = blockIdx.x * tb;
    const int nb = min(tb, B - b0);
    const int TM = nb * D;  // rows of this block

    // the block's inputs, all in flight at once: A, B0, gh (into Dt,
    // l-major), gp, bias
    const float* a_src = A + (size_t)b0 * H * D;
    const float* c_src = B0 + (size_t)b0 * F * D;
    for (int e = tid; e < nb * H * D; e += THREADS) cp_async4(As + e, a_src + e);
    for (int e = tid; e < nb * F * D; e += THREADS) cp_async4(Bs + e, c_src + e);
    if (gh != nullptr) {
        const int per = nh * D;
        const float* g_src = gh + (size_t)b0 * per;
        for (int e = tid; e < nb * per; e += THREADS) {
            const int bl = e / per, r = e - bl * per, l = r / D;
            cp_async4(Dt + l * TMS + bl * D + (r - l * D), g_src + e);
        }
    }
    if (gp != nullptr)
        for (int e = tid; e < nb * Lp; e += THREADS) cp_async4(Gp + e, gp + (size_t)b0 * Lp + e);
    for (int e = tid; e < L; e += THREADS) cp_async4(Bias + e, bias + e);
    cp_async_commit();

    // n_pad rows of `pitch` floats into dst: rows k0 .. k0 + n_rows - 1 of
    // W (columns l < L), zeros elsewhere, by 16-byte copies where W's rows
    // are aligned; each thread copies (and, under bf16, rounds) the same
    // elements. The pre phase takes chunks of KC rows, the dz phase the
    // rows of one h group.
    auto w_rows = [&](int k0, int n_rows, int n_pad, int pitch, float* dst, bool copy) {
        for (int kk = warp; kk < n_pad; kk += THREADS / 32) {
            float* d = dst + kk * pitch;
            const size_t row = (size_t)(k0 + kk) * L;
            if (vec) {
                for (int l = 4 * lane; l < pitch; l += 128) {
                    const bool ok = kk < n_rows && l < L;
                    if (copy) cp_async16(d + l, ok ? W + row + l : W, ok ? 16 : 0);
                    else round4(d + l);
                }
            } else {
                for (int l = lane; l < pitch; l += 32) {
                    const bool ok = kk < n_rows && l < L;
                    if (copy) cp_async4(d + l, ok ? W + row + l : W, ok ? 4 : 0);
                    else d[l] = to_bf16(d[l]);
                }
            }
        }
    };
    auto ws_chunk = [&](int k0, float* dst, bool copy) {
        w_rows(k0, min(KC, HF - k0), KC, LP, dst, copy);
    };
    auto w_group = [&](int h0, float* dst, bool copy) {
        w_rows(h0 * F, min(hc, H - h0) * F, kc2p, wp, dst, copy);
    };
    ws_chunk(0, Ws, true);
    cp_async_commit();

    for (int k = tid; k < HF; k += THREADS) {
        const int h = k / F;
        koff[k] = ((h * D) << 16) | ((k - h * F) * D);
    }
    for (int e = tid; e < ROWS * F; e += THREADS) dB0s[e] = 0.0f;
    // the row this thread stages and contracts; columns sg, sg + 2, ...
    const int sm = tid & (ROWS - 1), sg = tid >> 7;
    const bool srow = sm < TM;
    const int sbl = sm / D, sd = sm - sbl * D;
    const int a_row = sbl * H * D + sd, c_row = sbl * F * D + sd;
    cp_async_wait<1>();
    if (BF16) {  // the elements this thread copied
        for (int e = tid; e < nb * H * D; e += THREADS) As[e] = to_bf16(As[e]);
        for (int e = tid; e < nb * F * D; e += THREADS) Bs[e] = to_bf16(Bs[e]);
    }
    __syncthreads();

    // pre = z W + bias over all L columns: rows ty*8 + i, columns tx + 16 j;
    // the next W chunk loads while this one is multiplied
    float acc[8][RN];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;
    const int n_chunks = (HF + KC - 1) / KC;
    for (int c = 0; c < n_chunks; ++c) {
        const int k0 = c * KC;
#pragma unroll
        for (int t = 0; t < KC / 2; ++t) {  // all loads in flight at once
            const int kk = sg + 2 * t, k = k0 + kk;
            float z = 0.0f;
            if (srow && k < HF) {
                const int o = koff[k];
                const float p = As[a_row + (o >> 16)] * Bs[c_row + (o & 0xffff)];
                z = rnd<BF16>(p);
            }
            Zs[kk * TMS + sm] = z;
        }
        if (c + 1 < n_chunks) ws_chunk(k0 + KC, Ws + ((c + 1) & 1) * KC * LP, true);
        cp_async_commit();
        cp_async_wait<1>();
        const float* ws = Ws + (c & 1) * KC * LP;
        if (BF16) ws_chunk(k0, Ws + (c & 1) * KC * LP, false);
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < KC; ++kk) {
            const float4 z0 = *reinterpret_cast<const float4*>(&Zs[kk * TMS + ty * 8]);
            const float4 z1 = *reinterpret_cast<const float4*>(&Zs[kk * TMS + ty * 8 + 4]);
            const float zr[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
            float wr[RN];
#pragma unroll
            for (int j = 0; j < RN; ++j) wr[j] = ws[kk * LP + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(zr[i], wr[j], acc[i][j]);
        }
        __syncthreads();
    }
    w_group(0, Wg, true);  // the first group's W rows load during the epilogue
    cp_async_commit();

    // bias, mask: dpre to shared memory (rounded under bf16, for dz) and,
    // unrounded, to device memory once (for dW and dbias); each (l, row)
    // cell of Dt is read (gh) and written (dpre) by one thread
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int m = ty * 8 + i;
        const bool valid = m < TM;
        const int bl = m / D;
#pragma unroll
        for (int j = 0; j < RN; ++j) {
            const int l = tx + 16 * j;
            if (l >= L) continue;
            const float pre = acc[i][j] + Bias[l];
            float g = 0.0f;
            if (valid) {
                if (gh != nullptr && l < nh) g = Dt[l * TMS + m];
                if (gp != nullptr && l >= ps) g += Gp[bl * Lp + (l - ps)];
            }
            const float v = pre > 0.0f ? g : 0.0f;
            Dt[l * TMS + m] = rnd<BF16>(v);
            if (valid) dpre[((size_t)b0 * D + m) * L + l] = v;
        }
    }

    // dz for whole h groups, contracted into dA (per group) and dB0; the
    // next group's W rows load while this one is multiplied
    for (int h0 = 0, g = 0; h0 < H; h0 += hc, ++g) {
        const int nhc = min(hc, H - h0);
        const int ncol = nhc * F;
        float* wg = Wg + (g & 1) * kc2p * wp;
        cp_async_wait<0>();
        if (BF16) w_group(h0, wg, false);
        __syncthreads();
        if (h0 + hc < H) w_group(h0 + hc, Wg + ((g + 1) & 1) * kc2p * wp, true);
        cp_async_commit();
        for (int c0 = 0; c0 < kc2p; c0 += DZ) {
            float dz[8][4];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) dz[i][j] = 0.0f;
            // pair columns c0 + tx + 16 j: W rows read as float4, four l a step
            const float* wr = wg + (c0 + tx) * wp;
            const int L4 = L & ~3;
            for (int l = 0; l < L4; l += 4) {
                float4 w4[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    w4[j] = *reinterpret_cast<const float4*>(&wr[16 * j * wp + l]);
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const float4 p0 = *reinterpret_cast<const float4*>(&Dt[(l + q) * TMS + ty * 8]);
                    const float4 p1 =
                        *reinterpret_cast<const float4*>(&Dt[(l + q) * TMS + ty * 8 + 4]);
                    const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const float wv = q == 0 ? w4[j].x : q == 1 ? w4[j].y
                                       : q == 2 ? w4[j].z : w4[j].w;
#pragma unroll
                        for (int i = 0; i < 8; ++i) dz[i][j] = fmaf(pr[i], wv, dz[i][j]);
                    }
                }
            }
            for (int l = L4; l < L; ++l) {
                const float4 p0 = *reinterpret_cast<const float4*>(&Dt[l * TMS + ty * 8]);
                const float4 p1 = *reinterpret_cast<const float4*>(&Dt[l * TMS + ty * 8 + 4]);
                const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float wv = wr[16 * j * wp + l];
#pragma unroll
                    for (int i = 0; i < 8; ++i) dz[i][j] = fmaf(pr[i], wv, dz[i][j]);
                }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = c0 + tx + 16 * j;
                if (col >= ncol) continue;
#pragma unroll
                for (int i = 0; i < 8; ++i) Sz[(ty * 8 + i) * szs + col] = dz[i][j];
            }
        }
        __syncthreads();
        if (srow) {
            const float* zrow = Sz + sm * szs;
            // four independent sums at a time, each in ascending f (dA) or h (dB0)
            for (int h1 = sg; h1 < nhc; h1 += 8) {
                float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                for (int f = 0; f < F; ++f) {
                    const float bv = Bs[c_row + f * D];
#pragma unroll
                    for (int u = 0; u < 4; ++u)
                        s[u] = fmaf(zrow[min(h1 + 2 * u, nhc - 1) * F + f], bv, s[u]);
                }
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    if (h1 + 2 * u < nhc)
                        dA[(((size_t)b0 + sbl) * H + h0 + h1 + 2 * u) * D + sd] = s[u];
            }
            for (int f1 = sg; f1 < F; f1 += 8) {  // the group's partial sums, then added
                float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                for (int hh = 0; hh < nhc; ++hh) {
                    const float av = As[a_row + (h0 + hh) * D];
#pragma unroll
                    for (int u = 0; u < 4; ++u)
                        s[u] = fmaf(zrow[hh * F + min(f1 + 2 * u, F - 1)], av, s[u]);
                }
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    if (f1 + 2 * u < F) dB0s[sm * F + f1 + 2 * u] += s[u];
            }
        }
        __syncthreads();
    }
    if (srow)  // the same thread accumulated these (row, f)
        for (int f = sg; f < F; f += 2)
            dB0[(((size_t)b0 + sbl) * F + f) * D + sd] = dB0s[sm * F + f];
}

// ---------------------------------------------------------------- launch 2

template <bool BF16, int RN>
__global__ void __launch_bounds__(THREADS)
cin_bwd_dw_kernel(const float* __restrict__ A, const float* __restrict__ B0,
                  const float* __restrict__ dpre, int H, int F, int D, int L, int M,
                  int ms, float* __restrict__ part_w, float* __restrict__ part_b) {
    constexpr int LP = 16 * RN;
    __shared__ __align__(16) float Zs[KC][DW_TILE + 4];  // z rows m, columns k
    __shared__ __align__(16) float Ds[KC][LP];           // dpre rows m, columns l
    __shared__ int koff[DW_TILE];
    __shared__ float red[2][LP];

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int lane = tid & 31, warp = tid >> 5;
    const int HF = H * F;
    const int k0 = blockIdx.x * DW_TILE;
    const int s = blockIdx.y;
    const int m_beg = s * ms;
    const int m_end = min(M, m_beg + ms);
    const bool do_bias = blockIdx.x == 0;

    if (tid < DW_TILE) {
        const int k = k0 + tid;
        const int h = k / F;
        koff[tid] = k < HF ? (((h * D) << 16) | ((k - h * F) * D)) : -1;
    }
    // z staging: lane = row within the chunk, (b, d) of that row
    int zb = (m_beg + lane) / D;
    int zd = m_beg + lane - zb * D;
    // dpre staging: column dl, rows dg, dg + 2, ...
    const int dl = tid & (DW_TILE - 1), dg = tid >> 7;
    constexpr int NZ = DW_TILE / (THREADS / 32);
    float pa[NZ], pc[NZ], pd[KC / 2];  // the next chunk, loaded during this one
    auto load = [&](int mc) {
        const bool zrow = mc + lane < m_end;
        const int a_row = zb * H * D + zd, c_row = zb * F * D + zd;
#pragma unroll
        for (int t = 0; t < NZ; ++t) {
            const int o = koff[warp + (THREADS / 32) * t];
            const bool ok = zrow && o >= 0;
            pa[t] = ok ? A[a_row + (o >> 16)] : 0.0f;
            pc[t] = ok ? B0[c_row + (o & 0xffff)] : 0.0f;
        }
#pragma unroll
        for (int t = 0; t < KC / 2; ++t) {
            const int m = mc + dg + 2 * t;
            pd[t] = (dl < L && m < m_end) ? dpre[(size_t)m * L + dl] : 0.0f;
        }
        zd += KC;  // the next chunk's row: (b, d) advanced without division
        while (zd >= D) {
            zd -= D;
            ++zb;
        }
    };
    float bsum = 0.0f;

    float acc[8][RN];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;
    __syncthreads();
    load(m_beg);

    for (int mc = m_beg; mc < m_end; mc += KC) {
#pragma unroll
        for (int t = 0; t < NZ; ++t)
            Zs[lane][warp + (THREADS / 32) * t] =
                rnd<BF16>(rnd<BF16>(pa[t]) * rnd<BF16>(pc[t]));
        if (dl < LP) {
#pragma unroll
            for (int t = 0; t < KC / 2; ++t) {
                bsum += pd[t];
                Ds[dg + 2 * t][dl] = rnd<BF16>(pd[t]);
            }
        }
        __syncthreads();
        if (mc + KC < m_end) load(mc + KC);
#pragma unroll 8
        for (int mm = 0; mm < KC; ++mm) {
            const float4 z0 = *reinterpret_cast<const float4*>(&Zs[mm][ty * 8]);
            const float4 z1 = *reinterpret_cast<const float4*>(&Zs[mm][ty * 8 + 4]);
            const float zr[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
            float wr[RN];
#pragma unroll
            for (int j = 0; j < RN; ++j) wr[j] = Ds[mm][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(zr[i], wr[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int k = k0 + ty * 8 + i;
#pragma unroll
        for (int j = 0; j < RN; ++j) {
            const int l = tx + 16 * j;
            if (k < HF && l < L) part_w[((size_t)s * HF + k) * L + l] = acc[i][j];
        }
    }
    if (do_bias) {  // uniform across the block
        if (dl < LP) red[dg][dl] = bsum;
        __syncthreads();
        if (tid < L) part_b[(size_t)s * L + tid] = red[0][tid] + red[1][tid];
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

// ---------------------------------------------------------------- host

template <bool BF16, int RN>
int launch(const float* A, const float* B0, const float* W, const float* bias,
           const float* gh, const float* gp, int B, int H, int F, int D, int L, int nh,
           int ps, int tb, int ms, int slices, float* dA, float* dB0, float* dW,
           float* dbias, float* work, cudaStream_t stream) {
    const int M = B * D;
    const int HF = H * F;
    float* dpre = work;
    float* part_w = dpre + (size_t)M * L;
    float* part_b = part_w + (size_t)slices * HF * L;
    const size_t smem1 = row_smem(tb, H, F, D, L);

    cudaError_t err = cudaFuncSetAttribute(cin_bwd_rows_kernel<BF16, RN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem1);
    if (err != cudaSuccess) return (int)err;
    cin_bwd_rows_kernel<BF16, RN><<<(B + tb - 1) / tb, THREADS, smem1, stream>>>(
        A, B0, W, bias, gh, gp, B, H, F, D, L, tb, nh, ps, dpre, dA, dB0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    cin_bwd_dw_kernel<BF16, RN><<<dim3((HF + DW_TILE - 1) / DW_TILE, slices), THREADS, 0,
                                  stream>>>(A, B0, dpre, H, F, D, L, M, ms, part_w, part_b);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const int n_w = HF * L;
    cin_bwd_reduce_kernel<<<(n_w + L + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        part_w, part_b, slices, n_w, L, dW, dbias);
    return (int)cudaGetLastError();
}

template <bool BF16>
int launch_rn(int rn, const float* A, const float* B0, const float* W, const float* bias,
              const float* gh, const float* gp, int B, int H, int F, int D, int L, int nh,
              int ps, int tb, int ms, int slices, float* dA, float* dB0, float* dW,
              float* dbias, float* work, cudaStream_t st) {
#define CIN_BWD_LAUNCH(R)                                                                  \
    return launch<BF16, R>(A, B0, W, bias, gh, gp, B, H, F, D, L, nh, ps, tb, ms, slices, \
                           dA, dB0, dW, dbias, work, st)
    if (rn == 2) CIN_BWD_LAUNCH(2);
    if (rn == 4) CIN_BWD_LAUNCH(4);
    if (rn == 7) CIN_BWD_LAUNCH(7);
    CIN_BWD_LAUNCH(8);
#undef CIN_BWD_LAUNCH
}

}  // namespace

extern "C" {

// Shared memory (bytes) of launch 1 for `tb` batch rows a block; the
// wrapper mirrors it to choose tb.
long long cin_bwd_row_smem(int tb, int H, int F, int D, int L) {
    return (long long)row_smem(tb, H, F, D, L);
}

// Launches on `stream`; returns the first cudaError_t (0 on success).
// gh (B, nh, D) and gp (B, L - ps) may be null: a zero gradient. The
// geometry comes from the wrapper: tb batch rows a launch-1 block, slices
// of ms rows (a multiple of 32) over the B*D rows for dW; `work` holds
// B*D*L + slices*(H*F*L + L) floats.
int cin_bwd_launch(const float* A, const float* B0, const float* W, const float* bias,
                   const float* gh, const float* gp, int B, int H, int F, int D, int L,
                   int nh, int ps, int bf16, int tb, int ms, int slices, float* dA,
                   float* dB0, float* dW, float* dbias, float* work, void* stream) {
    const long long M = (long long)B * D;
    if (B <= 0 || H <= 0 || F <= 0 || D <= 0 || D > ROWS || L <= 0 || L > MAX_L ||
        nh < 0 || nh > L || ps < 0 || ps > L || tb <= 0 || tb * D > ROWS ||
        H * D >= 32768 || F * D >= 65536 || (long long)B * (H > F ? H : F) * D >= (1ll << 31) ||
        row_smem(tb, H, F, D, L) > (size_t)MAX_SMEM || ms <= 0 || ms % KC != 0 ||
        slices <= 0 || slices > 65535 || (long long)slices * ms < M ||
        (long long)(slices - 1) * ms >= M) {
        return (int)cudaErrorInvalidValue;
    }
    const int rn = rn_of(L);
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16) {
        return launch_rn<true>(rn, A, B0, W, bias, gh, gp, B, H, F, D, L, nh, ps, tb, ms,
                               slices, dA, dB0, dW, dbias, work, st);
    }
    return launch_rn<false>(rn, A, B0, W, bias, gh, gp, B, H, F, D, L, nh, ps, tb, ms,
                            slices, dA, dB0, dW, dbias, work, st);
}

}  // extern "C"
