// expand_score: squared L2 between query q[b] and corpus row x[idx[b, c]],
// +inf where idx[b, c] < 0.  Two entry points: an f32 corpus (the f32 plane
// and the f32 rerank plane) and a bf16 corpus (the bf16 plane), whose
// elements are widened to f32 in registers (__bfloat162float, exact).
//
// Replaces the Pallas kernel src/repro/kernels/expand_score.py::expand_score
// (scalar-prefetch row gather, one (1, d) row DMA per candidate; the bf16
// plane takes the same Pallas kernel, which casts the row in-register).
//
// Bound on the H100: bytes.  Each candidate reads one 4d-byte (bf16: 2d)
// corpus row at a random address and does 3d flops on it, far below the
// card's ~20 flops per byte, so the gather of B*C rows over 3.35 TB/s is the
// floor.
//
// Design: one warp per (b, c) candidate.  The warp reads the row with
// coalesced loads (lane l takes elements l, l+32, ...: 128 bytes a step in
// f32, 64 in bf16), so each row costs d/32 memory transactions and no
// (B, C, d) tensor ever exists.  The query row comes through L1, where the
// C warps of one query share it.  Masked candidates (idx < 0) fetch nothing.
// The sum runs in the fixed order of common.cuh.
#include <cuda_bf16.h>

#include "common.cuh"

template <typename T>
__device__ __forceinline__ float widen(T v);

template <>
__device__ __forceinline__ float widen<float>(float v) { return v; }

template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

template <typename T>
__global__ void expand_score_kernel(const T* __restrict__ x,
                                    const int* __restrict__ idx,
                                    const float* __restrict__ q,
                                    float* __restrict__ out,
                                    long long n, int d, long long total, int C) {
    const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= total) return;  // warp-uniform
    const int id = idx[warp];
    if (id < 0) {
        if (lane == 0) out[warp] = __int_as_float(0x7f800000);  // +inf
        return;
    }
    const long long row = id < n ? id : n - 1;
    const long long b = warp / C;
    const T* xr = x + row * d;
    const float acc = warp_sq_dist_row(q + b * d, [xr](int k) { return widen(xr[k]); }, d, lane);
    if (lane == 0) out[warp] = acc;
}

template <typename T>
static int launch(const T* x, const int* idx, const float* q, float* out,
                  long long n, int d, int B, int C, cudaStream_t stream) {
    const long long total = static_cast<long long>(B) * C;
    const int threads = 256;
    const long long warps_per_block = threads / 32;
    const long long blocks = (total + warps_per_block - 1) / warps_per_block;
    expand_score_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        x, idx, q, out, n, d, total, C);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_expand_score(const float* x, const int* idx, const float* q,
                                  float* out, long long n, int d, int B, int C,
                                  cudaStream_t stream) {
    return launch(x, idx, q, out, n, d, B, C, stream);
}

extern "C" int repro_expand_score_bf16(const __nv_bfloat16* x, const int* idx, const float* q,
                                       float* out, long long n, int d, int B, int C,
                                       cudaStream_t stream) {
    return launch(x, idx, q, out, n, d, B, C, stream);
}
