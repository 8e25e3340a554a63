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
// of Z is the pair vector z[h*F+f] = A[b,h,d] * B0[b,f,d]. What bounds it
// on the H100 (B = 8192, D = 10, F = 7, L = 100, pair axes 49, 350, 350):
// 2*B*D*HF*L = 12.3 GFLOP of f32 FMA per 3-layer forward (0.18 ms at 67
// TFLOP/s) against about 35 MB per wide layer (0.01 ms at 3.35 TB/s):
// operations. So the time must go to FMAs. The design:
//   1. a block owns `tb` whole batch rows (tb * D <= 128 rows (b, d); the
//      wrapper's `fwd_geometry` picks tb) and all L columns in one pass:
//      16 column threads x RN, RN = ceil(L / 16) rounded to 2 / 4 / 7 / 8
//      (112 columns at L = 100). An L above 128 takes passes of 128
//      columns, each walking the pair axis again. A layer whose batch row
//      does not fit (D > 128, or A's rows beyond shared memory) is launched
//      over spans of D (`fwd_plan`): the layer is separable over d;
//   2. the block's A and B0 rows (contiguous) go to shared memory once, by
//      16-byte cp.async where aligned; each z chunk is formed from them
//      through a pair-offset table (h*D, f*D), no division in the loop;
//   3. the pair axis streams through a 2-stage ring of KC = 32 pair rows:
//      while the block multiplies chunk c, W's rows of chunk c + 1 arrive by
//      cp.async (16 bytes where W's rows are aligned) and its z chunk is
//      formed, with one barrier a chunk. W of any size (F = 39: 1950 x 100,
//      780 KB) streams through; the last chunk runs only its live rows, so
//      no FMA is spent on padding of the pair axis;
//   4. each thread holds an 8 x RN register tile (8 x 7 at L = 100: 56 FMAs
//      per 2 float4 of z and 7 floats of W from shared memory), a plain
//      f32 FMA loop in ascending pair order (no TF32); a warp whose 16 rows
//      all lie past the block's rows skips it;
//   5. the epilogue adds bias and applies ReLU into a tile that reuses the
//      ring's shared memory, writes the hidden rows (each thread one (l, d)
//      of the run every batch row shares, no division per element) and sums
//      each pooled row over D in ascending d inside the block. No atomics:
//      the result is deterministic and equals a plain f32 product bit for
//      bit wherever every sum is exact.
// At the published widths a block takes 92,000 bytes of shared memory and
// at most 128 registers a thread, so two blocks share an SM; a wide layer
// then runs at about a third of its f32 bound. Taking parts out of the
// kernel on the card leaves most of its time in the FMA loop and the next
// largest part in forming z (PERF.md).
// With `bf16` set, A, B0 and W are rounded to bf16 first, then each product
// A*B0 is rounded to bf16, then multiplied by W with f32 accumulation: the
// order of `_make_pooled_fwd` (:263-269). I/O stays f32 in both modes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RM = 8;                       // rows (b, d) a thread
constexpr int ROWS = 128;                   // rows (b, d) a block owns at most
constexpr int THREADS = 16 * (ROWS / RM);   // 16 column threads x ROWS / RM row groups
constexpr int ZSTEP = THREADS / ROWS;       // threads forming one row of a z chunk
constexpr int KC = 32;                      // pair rows a chunk of the ring
constexpr int MAX_SMEM = 232448;

__host__ __device__ constexpr size_t a4(size_t n) { return (n + 3) / 4 * 4; }

__host__ __device__ inline int rn_of(int L) {
    const int c = (L + 15) / 16;
    return c <= 2 ? 2 : c <= 4 ? 4 : c <= 7 ? 7 : 8;
}

// the ring (two z chunks and two W chunks) and the output tile of a pass
// share one region, in floats
__host__ __device__ inline size_t region_floats(int L) {
    const size_t lp = 16 * (size_t)rn_of(L);
    const size_t ring = 2 * (size_t)KC * (ROWS + lp);
    const size_t tile = (size_t)ROWS * (lp + 1);
    return ring > tile ? ring : tile;
}

// bytes: the A and B0 tiles, bias, the region, the pair-offset table
size_t fwd_smem(int tb, int H, int F, int D, int L) {
    return 4 * (a4((size_t)tb * H * D) + a4((size_t)tb * F * D) + a4(L) + region_floats(L)) +
           8 * (size_t)H * F;
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

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void round4(float* p) {
    for (int q = 0; q < 4; ++q) p[q] = to_bf16(p[q]);
}

// n contiguous floats from src to dst (16-byte aligned), by 16-byte copies
// where src is aligned too; with `copy` false each thread instead rounds
// to bf16 the elements it copied
__device__ __forceinline__ void stage(float* dst, const float* src, int n, int tid, bool copy) {
    int e0 = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const int n4 = n >> 2;
        for (int q = tid; q < n4; q += THREADS) {
            if (copy) cp_async16(dst + 4 * q, src + 4 * q, 16);
            else round4(dst + 4 * q);
        }
        e0 = 4 * n4;
    }
    for (int e = e0 + tid; e < n; e += THREADS) {
        if (copy) cp_async4(dst + e, src + e);
        else dst[e] = to_bf16(dst[e]);
    }
}

template <bool BF16, int RN>
__global__ void __launch_bounds__(THREADS, 2)
cin_fused_kernel(const float* __restrict__ A, const float* __restrict__ B0,
                 const float* __restrict__ W, const float* __restrict__ bias,
                 int B, int H, int F, int D, int L, int tb, int nh, int ps,
                 float* __restrict__ hidden, float* __restrict__ pooled) {
    constexpr int LP = 16 * RN;  // columns a pass covers
    constexpr int SP = LP + 1;   // pitch of the output tile
    extern __shared__ __align__(16) float smem[];
    const int HF = H * F;
    const int Lp = L - ps;
    float* As = smem;                             // [tb][H][D]
    float* Bs = As + a4((size_t)tb * H * D);      // [tb][F][D]
    float* Bias = Bs + a4((size_t)tb * F * D);    // [L]
    float* Zs = Bias + a4(L);                     // [2][KC][ROWS] z chunks, pair-major
    float* Ws = Zs + 2 * KC * ROWS;               // [2][KC][LP]   W chunks
    float* S = Zs;                                // [ROWS][SP]    relu(conv) of a pass
    int2* koff = reinterpret_cast<int2*>(Zs + region_floats(L));  // [HF] (h*D, f*D)

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int lane = tid & 31, warp = tid >> 5;
    const int b0 = blockIdx.x * tb;
    const int nb = min(tb, B - b0);
    const int TM = nb * D;  // rows of this block
    const bool busy = 2 * RM * warp < TM;  // a warp covers 2 row groups
    const float* a_src = A + (size_t)b0 * H * D;
    const float* c_src = B0 + (size_t)b0 * F * D;
    // 16-byte copies of W rows where they are aligned (passes start at
    // multiples of 128 columns)
    const bool wvec = (L & 3) == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0;

    // pair rows k0 .. k0 + KC - 1 of W, columns l0 .. l0 + LP - 1 (zeros
    // past L) into dst; rows past HF are never read. With `copy` false each
    // thread instead rounds to bf16 the elements it copied
    auto w_chunk = [&](int k0, int l0, float* dst, bool copy) {
        const int nk = min(KC, HF - k0);
        for (int kk = warp; kk < nk; kk += THREADS / 32) {
            float* d = dst + kk * LP;
            const float* src = W + (size_t)(k0 + kk) * L + l0;
            if (wvec) {
                for (int c = 4 * lane; c < LP; c += 128) {
                    const bool ok = l0 + c < L;
                    if (copy) cp_async16(d + c, ok ? src + c : W, ok ? 16 : 0);
                    else round4(d + c);
                }
            } else {
                for (int c = lane; c < LP; c += 32) {
                    const bool ok = l0 + c < L;
                    if (copy) cp_async4(d + c, ok ? src + c : W, ok ? 4 : 0);
                    else d[c] = to_bf16(d[c]);
                }
            }
        }
    };

    // the block's inputs, all in flight at once: A, B0, bias and the first
    // W chunk
    stage(As, a_src, nb * H * D, tid, true);
    stage(Bs, c_src, nb * F * D, tid, true);
    for (int e = tid; e < L; e += THREADS) cp_async4(Bias + e, bias + e);
    w_chunk(0, 0, Ws, true);
    cp_async_commit();
    for (int k = tid; k < HF; k += THREADS) {
        const int h = k / F;
        koff[k] = make_int2(h * D, (k - h * F) * D);
    }
    cp_async_wait_all();
    if (BF16) {
        stage(As, a_src, nb * H * D, tid, false);
        stage(Bs, c_src, nb * F * D, tid, false);
        w_chunk(0, 0, Ws, false);
    }
    __syncthreads();

    // the row of Z this thread forms: pair rows sg, sg + ZSTEP, ... of a chunk
    const int sm = tid % ROWS, sg = tid / ROWS;
    const bool srow = sm < TM;
    const int sbl = srow ? sm / D : 0, sd = srow ? sm - sbl * D : 0;
    const float* a_row = As + sbl * H * D + sd;
    const float* c_row = Bs + sbl * F * D + sd;
    auto z_chunk = [&](int k0, float* dst) {
#pragma unroll
        for (int t = 0; t < KC / ZSTEP; ++t) {  // all loads in flight at once
            const int kk = sg + ZSTEP * t, k = k0 + kk;
            float z = 0.0f;
            if (srow && k < HF) {
                const int2 o = koff[k];
                z = rnd<BF16>(a_row[o.x] * c_row[o.y]);
            }
            dst[kk * ROWS + sm] = z;
        }
    };

    const int n_chunks = (HF + KC - 1) / KC;
    for (int l0 = 0; l0 < L; l0 += LP) {
        if (l0 > 0) {
            w_chunk(0, l0, Ws, true);
            cp_async_commit();
        }
        z_chunk(0, Zs);
        if (l0 > 0) {
            cp_async_wait_all();
            if (BF16) w_chunk(0, l0, Ws, false);
        }
        __syncthreads();

        float acc[RM][RN];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;

        for (int c = 0; c < n_chunks; ++c) {
            const int k0 = c * KC;
            const bool more = c + 1 < n_chunks;
            // the next chunk arrives and is formed while this one is multiplied
            if (more) {
                w_chunk(k0 + KC, l0, Ws + ((c + 1) & 1) * KC * LP, true);
                cp_async_commit();
                z_chunk(k0 + KC, Zs + ((c + 1) & 1) * KC * ROWS);
            }
            if (busy) {
                const float* zs = Zs + (c & 1) * KC * ROWS + ty * RM;
                const float* ws = Ws + (c & 1) * KC * LP + tx;
                const int kn = min(KC, HF - k0);
#pragma unroll 4
                for (int kk = 0; kk < kn; ++kk) {
                    const float4 z0 = *reinterpret_cast<const float4*>(zs + kk * ROWS);
                    const float4 z1 = *reinterpret_cast<const float4*>(zs + kk * ROWS + 4);
                    const float zr[RM] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
                    float wr[RN];
#pragma unroll
                    for (int j = 0; j < RN; ++j) wr[j] = ws[kk * LP + 16 * j];
#pragma unroll
                    for (int i = 0; i < RM; ++i)
#pragma unroll
                        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(zr[i], wr[j], acc[i][j]);
                }
            }
            if (more) {
                cp_async_wait_all();
                if (BF16) w_chunk(k0 + KC, l0, Ws + ((c + 1) & 1) * KC * LP, false);
            }
            __syncthreads();
        }

        // epilogue: bias + relu into the tile (the ring is consumed)
#pragma unroll
        for (int j = 0; j < RN; ++j) {
            const int c = tx + 16 * j;
            const float bj = l0 + c < L ? Bias[l0 + c] : 0.0f;
#pragma unroll
            for (int i = 0; i < RM; ++i) S[(ty * RM + i) * SP + c] = fmaxf(acc[i][j] + bj, 0.0f);
        }
        __syncthreads();

        const int n_cols = min(LP, L - l0);
        // hidden rows l < nh: for each batch row a contiguous run of (l, d),
        // element r of the run the same (c, d) in every batch row
        const int nh_cols = max(0, min(n_cols, nh - l0));
        for (int r = tid; r < nh_cols * D; r += THREADS) {
            const int c = r / D;
            const float* s = S + (r - c * D) * SP + c;
            float* h = hidden + ((size_t)b0 * nh + l0) * D + r;
            for (int bl = 0; bl < nb; ++bl) h[(size_t)bl * nh * D] = s[bl * D * SP];
        }
        // pooled rows l >= ps: sum over d in ascending order
        const int cp0 = max(0, ps - l0);
        const int np_cols = n_cols - cp0;
        if (np_cols > 0) {
            for (int e = tid; e < nb * np_cols; e += THREADS) {
                const int bl = e / np_cols;
                const int c = cp0 + (e - bl * np_cols);
                float s = 0.0f;
                for (int d = 0; d < D; ++d) s += S[(bl * D + d) * SP + c];
                pooled[(size_t)(b0 + bl) * Lp + (l0 + c - ps)] = s;
            }
        }
        __syncthreads();  // the next pass reuses the region
    }
}

template <bool BF16, int RN>
int launch(const float* A, const float* B0, const float* W, const float* bias, int B,
           int H, int F, int D, int L, int tb, int nh, int ps, float* hidden,
           float* pooled, cudaStream_t stream) {
    const size_t smem = fwd_smem(tb, H, F, D, L);
    cudaError_t err = cudaFuncSetAttribute(cin_fused_kernel<BF16, RN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(cin_fused_kernel<BF16, RN>,
                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    cin_fused_kernel<BF16, RN><<<(B + tb - 1) / tb, THREADS, smem, stream>>>(
        A, B0, W, bias, B, H, F, D, L, tb, nh, ps, hidden, pooled);
    return (int)cudaGetLastError();
}

template <bool BF16>
int launch_rn(const float* A, const float* B0, const float* W, const float* bias, int B,
              int H, int F, int D, int L, int tb, int nh, int ps, float* hidden,
              float* pooled, cudaStream_t st) {
#define CIN_FWD_LAUNCH(R) \
    return launch<BF16, R>(A, B0, W, bias, B, H, F, D, L, tb, nh, ps, hidden, pooled, st)
    const int rn = rn_of(L);
    if (rn == 2) CIN_FWD_LAUNCH(2);
    if (rn == 4) CIN_FWD_LAUNCH(4);
    if (rn == 7) CIN_FWD_LAUNCH(7);
    CIN_FWD_LAUNCH(8);
#undef CIN_FWD_LAUNCH
}

}  // namespace

extern "C" {

// Shared memory (bytes) of a block of `tb` batch rows; the wrapper mirrors
// it to choose tb.
long long cin_fused_smem(int tb, int H, int F, int D, int L) {
    return (long long)fwd_smem(tb, H, F, D, L);
}

// Launches on `stream`; returns the first cudaError_t (0 on success).
// hidden (B, nh, D) may be null when nh == 0, pooled (B, L - ps) when ps == L.
// tb, the batch rows a block owns, comes from the wrapper.
int cin_fused_launch(const float* A, const float* B0, const float* W,
                     const float* bias, int B, int H, int F, int D, int L,
                     int nh, int ps, int bf16, int tb, float* hidden, float* pooled,
                     void* stream) {
    if (B <= 0 || H <= 0 || F <= 0 || D <= 0 || D > ROWS || L <= 0 || nh < 0 ||
        nh > L || ps < 0 || ps > L || tb <= 0 || tb * D > ROWS ||
        (long long)H * F * D >= (1ll << 31) || fwd_smem(tb, H, F, D, L) > (size_t)MAX_SMEM ||
        (nh > 0 && hidden == nullptr) || (ps < L && pooled == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16) return launch_rn<true>(A, B0, W, bias, B, H, F, D, L, tb, nh, ps, hidden, pooled, st);
    return launch_rn<false>(A, B0, W, bias, B, H, F, D, L, tb, nh, ps, hidden, pooled, st);
}

}  // extern "C"
