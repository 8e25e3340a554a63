// Row-sparse lazy Adam: one in-place step on the touched rows of the
// (V, D) parameter, first-moment and second-moment tables.
//
// Replaces the Pallas TPU kernel oovrec_tpu/ops/sparse_rows.py:
// sparse_adam_rows_kernel (body `_kernel`, pallas_call at :127). It computes
// the same function; the blocking is Hopper's own, not the TPU's.
//
// Contract (the caller, train/sparse_update.py, coalesces first): ids (n,)
// sorted ascending, duplicates allowed; g (n, D) with every duplicate
// position carrying the same full row sum. For each position j that is the
// first of its id (ids[j] != ids[j-1]) and whose gradient row is not all
// zeros:
//     m' = b1*m + (1-b1)*g
//     v' = b2*v + ((1-b2)*g)*g
//     p' = p - lr * ((m'/bc0) / (sqrt(v'/bc1) + eps))
// with bc = [1 - b1^c, 1 - b2^c] from the shared post-increment count c.
// Rows that are not touched are never read or written.
//
// The TPU kernel walks the sorted ids in order on one core, keeps the 8-row
// tile that holds the current id in VMEM across consecutive ids and picks
// the row with an iota mask; V and n must be multiples of 8 (Mosaic). None
// of that carries over. Here one warp owns one position: it reads its id
// and the one before, traps if they descend (the sortedness check, with no
// launch of its own), returns on a duplicate (so a row is stepped once and
// no atomics are needed), finds "touched" with __any_sync over the row, and
// updates the row in place, two floats a lane (float2) when D is even and
// the rows are 8-byte aligned, one otherwise, the tail masked by the loop
// bound. Any V, n and D.
//
// Bound: bytes. A distinct touched row moves 3 x 2 x D x 4 bytes of p, mu
// and nu (read and write) plus D x 4 bytes of g and its id; the arithmetic
// is ~16 flops an element. At the training step's shapes (8,192 user ids
// into 200,000 x 64 and 16,384 item ids into 100,000 x 64, about 23,000
// distinct rows) that is ~42 MB, ~12 us at 3.35 TB/s, so the launch itself
// (a few us) is a large share. Every row access is a whole 256-byte row
// read by one warp, coalesced.
//
// The arithmetic is written with __fmul_rn / __fadd_rn / __fdiv_rn /
// __fsqrt_rn in the plain version's order, so nvcc cannot contract it into
// FMAs and the kernel equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // positions per block
constexpr int THREADS = WARPS * 32;

struct Hyper {
    float lr, b1, omb1, b2, omb2, eps, bc0, bc1;
};

__device__ __forceinline__ void adam_elem(float& p, float& m, float& v, float g,
                                          const Hyper& h) {
    const float m2 = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
    const float v2 = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
    const float mh = __fdiv_rn(m2, h.bc0);
    const float vh = __fdiv_rn(v2, h.bc1);
    const float step = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), h.eps));
    p = __fsub_rn(p, __fmul_rn(h.lr, step));
    m = m2;
    v = v2;
}

template <typename Id>
__global__ void __launch_bounds__(THREADS)
sparse_adam_rows_kernel(float* __restrict__ p, float* __restrict__ mu,
                        float* __restrict__ nu, const Id* __restrict__ ids,
                        const float* __restrict__ g, int n, int d, bool vec,
                        Hyper h) {
    const int j = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (j >= n) return;  // warp-uniform
    const int64_t row = (int64_t)ids[j];
    if (j > 0) {
        const int64_t prev = (int64_t)ids[j - 1];
        if (prev > row) __trap();  // ids not sorted: a device fault, as an assert
        if (prev == row) return;   // duplicate: warp-uniform
    }
    const float* gr = g + (int64_t)j * d;
    const int64_t off = row * d;
    if (vec) {
        const int d2 = d >> 1;
        const float2* g2 = reinterpret_cast<const float2*>(gr);
        bool nz = false;
        for (int c = lane; c < d2; c += 32) {
            const float2 x = g2[c];
            nz |= (x.x != 0.f) | (x.y != 0.f);
        }
        if (!__any_sync(0xffffffffu, nz)) return;  // zero row: pass through
        float2* p2 = reinterpret_cast<float2*>(p + off);
        float2* m2 = reinterpret_cast<float2*>(mu + off);
        float2* v2 = reinterpret_cast<float2*>(nu + off);
        for (int c = lane; c < d2; c += 32) {
            const float2 gx = g2[c];
            float2 pp = p2[c], mm = m2[c], vv = v2[c];
            adam_elem(pp.x, mm.x, vv.x, gx.x, h);
            adam_elem(pp.y, mm.y, vv.y, gx.y, h);
            p2[c] = pp;
            m2[c] = mm;
            v2[c] = vv;
        }
    } else {
        bool nz = false;
        for (int c = lane; c < d; c += 32) nz |= gr[c] != 0.f;
        if (!__any_sync(0xffffffffu, nz)) return;
        for (int c = lane; c < d; c += 32) {
            float pp = p[off + c], mm = mu[off + c], vv = nu[off + c];
            adam_elem(pp, mm, vv, gr[c], h);
            p[off + c] = pp;
            mu[off + c] = mm;
            nu[off + c] = vv;
        }
    }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// ids_bytes is 4 (int32) or 8 (int64).
int sparse_adam_rows_launch(float* p, float* mu, float* nu, const void* ids,
                            int ids_bytes, const float* g, int n, int d,
                            float lr, float b1, float omb1, float b2,
                            float omb2, float eps, float bc0, float bc1,
                            void* stream) {
    if (n < 0 || d <= 0 || (ids_bytes != 4 && ids_bytes != 8)) {
        return (int)cudaErrorInvalidValue;
    }
    if (n == 0) return (int)cudaSuccess;
    const Hyper h{lr, b1, omb1, b2, omb2, eps, bc0, bc1};
    // float2 rows when D is even and every table and g start 8-byte aligned
    const bool vec = (d % 2 == 0) &&
        ((((uintptr_t)p) | ((uintptr_t)mu) | ((uintptr_t)nu) | ((uintptr_t)g)) % 8 == 0);
    const dim3 grid((n + WARPS - 1) / WARPS);
    cudaStream_t s = (cudaStream_t)stream;
    if (ids_bytes == 4) {
        sparse_adam_rows_kernel<int32_t><<<grid, THREADS, 0, s>>>(
            p, mu, nu, (const int32_t*)ids, g, n, d, vec, h);
    } else {
        sparse_adam_rows_kernel<int64_t><<<grid, THREADS, 0, s>>>(
            p, mu, nu, (const int64_t*)ids, g, n, d, vec, h);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
