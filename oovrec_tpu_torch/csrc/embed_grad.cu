// The backward of a row gather: the cotangents of each id summed into its
// row of a (V, D) table, by sort and segment, with no atomics.
//
// Replaces the scatter-add backward of oovrec_tpu/ops/embed_grad.py:
// gather_rows (:90) and packed_gather (:161). Those are JAX custom-VJP
// gathers, not Pallas kernels; their TPU backward is a one-hot matmul or
// XLA's serialised scatter-add. On the card the trouble is duplicates:
// branchless routing gathers the placeholder bucket 0 for every IV row,
// and a small-vocabulary token field repeats a few rows a whole batch
// long; torch's indexing backward adds the duplicates of one id one after
// another in one warp.
//
// Contract: g (n, D) f32 row-major, ids (n,) int32 or int64 in [0, V),
// live (n,) uint8 or null; out (V, D) f32. out[r] = the sum of g[i] over
// the positions i with ids[i] == r and live[i] != 0. A row that is not
// live adds nothing (routing throws it away; its cotangent is zero).
//
// Steps, all on `stream`, no host read:
//   1. out = 0 (cudaMemsetAsync);
//   2. keys: live ? id : V (the discarded rows sort last, under key V),
//      values: the position;
//   3. a stable radix sort of the (key, position) pairs over the bits that
//      V needs (cub::DeviceRadixSort, stable: equal keys keep ascending
//      positions);
//   4. `segment_chunks`: the sorted positions cut into chunks of CHUNK; a
//      block walks its chunk in order and sums each run piece column by
//      column. A piece that is a whole run goes to out; the first piece of
//      a run that began in an earlier chunk goes to head[chunk]; the last
//      piece of a run that goes on into the next chunk goes to
//      tail[chunk]. Key V (the discarded rows) is skipped;
//   5. `segment_runs`: the chunk where a crossing run starts owns it and
//      adds tail[chunk] and the head partials of the chunks the run covers,
//      LANES lanes a column each taking every LANES-th chunk in order, then
//      the lanes in order.
// Every sum has one fixed order for given inputs, so the result has the
// same bits on every run. A run of n duplicates costs n / CHUNK chunk
// partials summed LANES-wide, not n serial adds.
//
// Bound: bytes. g and ids read once and the touched rows written once:
// (n x D + touched x D) x 4 + n x 8 bytes (0.7 us at 8,192 x 64 and 3.35
// TB/s); the launches (the sort takes several) dominate at these sizes.

#include <cub/cub.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 32;  // sorted positions a block of `segment_chunks` walks
constexpr int LANES = 8;   // lanes a column in `segment_runs`

template <typename Id>
__global__ void make_keys(const Id* __restrict__ ids, const uint8_t* __restrict__ live, int n,
                          unsigned int dead, unsigned int* __restrict__ keys,
                          int* __restrict__ pos) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    keys[i] = (live == nullptr || live[i]) ? (unsigned int)ids[i] : dead;
    pos[i] = i;
}

__global__ void segment_chunks(const float* __restrict__ g, const unsigned int* __restrict__ sk,
                               const int* __restrict__ perm, int n, int d, unsigned int dead,
                               float* __restrict__ out, float* __restrict__ head,
                               float* __restrict__ tail) {
    __shared__ unsigned int keys[CHUNK];
    __shared__ int rows[CHUNK];
    const int c = blockIdx.x;
    const int start = c * CHUNK;
    const int len = min(CHUNK, n - start);
    for (int p = threadIdx.x; p < len; p += blockDim.x) {
        keys[p] = sk[start + p];
        rows[p] = perm[start + p];
    }
    __syncthreads();
    // a run that began before this chunk / goes on after it
    const bool from_prev = start > 0 && sk[start - 1] == keys[0];
    const bool into_next = start + len < n && sk[start + len] == keys[len - 1];
    for (int col = threadIdx.x; col < d; col += blockDim.x) {
        // the chunk's column loaded first, every load independent (the
        // discarded rows not at all), then summed in order from registers
        float vals[CHUNK];
#pragma unroll
        for (int p = 0; p < CHUNK; ++p) {
            vals[p] = (p < len && keys[p] != dead) ? g[(size_t)rows[p] * d + col] : 0.f;
        }
        // a run piece [first, ..) to out, head or tail
        auto flush = [&](int first, bool last, float acc) {
            const unsigned int key = keys[first];
            if (key == dead) return;
            if (first == 0 && from_prev) {
                head[(size_t)c * d + col] = acc;
            } else if (last && into_next) {
                tail[(size_t)c * d + col] = acc;
            } else {
                out[(size_t)key * d + col] = acc;
            }
        };
        float acc = 0.f;
        int first = 0;
#pragma unroll
        for (int p = 0; p < CHUNK; ++p) {
            if (p < len) {
                if (keys[p] != keys[first]) {
                    flush(first, false, acc);
                    acc = 0.f;
                    first = p;
                }
                acc += vals[p];
            }
        }
        flush(first, true, acc);
    }
}

__global__ void segment_runs(const unsigned int* __restrict__ sk, int n, int d,
                             unsigned int dead, const float* __restrict__ head,
                             const float* __restrict__ tail, float* __restrict__ out) {
    __shared__ float part[LANES][32];
    const int c = blockIdx.x;
    const int start = c * CHUNK;
    const int end = min(start + CHUNK, n);
    if (end >= n) return;
    const unsigned int key = sk[end - 1];
    // owner: the run goes on into the next chunk and did not come from the
    // previous one through this whole chunk
    if (key == dead || sk[end] != key) return;
    if (start > 0 && sk[start - 1] == key && sk[start] == key) return;
    // the run's last position: the first sorted key above `key`, searched
    // in (end, n)
    int lo = end, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (sk[mid] <= key) lo = mid + 1; else hi = mid;
    }
    const int last_chunk = (lo - 1) / CHUNK;
    const int lane = threadIdx.y;
    for (int col0 = 0; col0 < d; col0 += 32) {
        const int col = col0 + threadIdx.x;
        float acc = 0.f;
        if (col < d) {
            for (int k = c + 1 + lane; k <= last_chunk; k += LANES) {
                acc += head[(size_t)k * d + col];
            }
        }
        part[lane][threadIdx.x] = acc;
        __syncthreads();
        if (lane == 0 && col < d) {
            float sum = tail[(size_t)c * d + col];
            for (int l = 0; l < LANES; ++l) sum += part[l][threadIdx.x];
            out[(size_t)key * d + col] = sum;
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" {

// The chunk length, which sizes the caller's head and tail scratch.
int embed_grad_chunk(void) { return CHUNK; }

// Bytes of sort scratch for n pairs (the caller allocates them).
int embed_grad_sort_bytes(int n, size_t* bytes) {
    *bytes = 0;
    return (int)cub::DeviceRadixSort::SortPairs(
        nullptr, *bytes, (const unsigned int*)nullptr, (unsigned int*)nullptr,
        (const int*)nullptr, (int*)nullptr, n, 0, 32);
}

// The table gradient of a gather: see the contract above. Scratch: keys
// and pos (2 x n int32 each: in and out), head and tail (n_chunks x D f32
// each), temp (temp_bytes). Returns cudaGetLastError() (0 on success).
int embed_grad_backward(const float* g, const void* ids, int ids_bytes, const uint8_t* live,
                        int n, int d, int n_rows, float* out, unsigned int* keys, int* pos,
                        float* head, float* tail, void* temp, size_t temp_bytes,
                        void* stream) {
    if (n < 0 || d <= 0 || n_rows <= 0 || (ids_bytes != 4 && ids_bytes != 8)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n_rows * d * sizeof(float), s);
    if (err != cudaSuccess || n == 0) return (int)err;
    const unsigned int dead = (unsigned int)n_rows;
    int end_bit = 1;
    while (end_bit < 32 && (dead >> end_bit) != 0) ++end_bit;
    const int block = 256;
    const int grid = (n + block - 1) / block;
    if (ids_bytes == 4) {
        make_keys<int32_t><<<grid, block, 0, s>>>((const int32_t*)ids, live, n, dead, keys, pos);
    } else {
        make_keys<int64_t><<<grid, block, 0, s>>>((const int64_t*)ids, live, n, dead, keys, pos);
    }
    unsigned int* sk = keys + n;
    int* perm = pos + n;
    err = cub::DeviceRadixSort::SortPairs(temp, temp_bytes, keys, sk, pos, perm, n, 0, end_bit,
                                          s);
    if (err != cudaSuccess) return (int)err;
    const int n_chunks = (n + CHUNK - 1) / CHUNK;
    const int threads = min(128, ((d + 31) / 32) * 32);
    segment_chunks<<<n_chunks, threads, 0, s>>>(g, sk, perm, n, d, dead, out, head, tail);
    segment_runs<<<n_chunks, dim3(32, LANES), 0, s>>>(sk, n, d, dead, head, tail, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
