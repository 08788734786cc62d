// expand_score_q: squared L2 between query q[b] and the int8 corpus row
// x[idx[b, c]] dequantized as x * scale + zero, +inf where idx[b, c] < 0.
//
// Replaces the Pallas kernel src/repro/kernels/expand_score.py::expand_score_q
// (the scalar-prefetch row gather of expand_score on an int8 plane, the row
// dequantized in-register before the square-difference sum).
//
// Bound on the H100: bytes.  Each candidate reads one d-byte int8 row at a
// random address and does 5d flops on it; the gather of the live rows, the
// ids, the outputs and the queries over 3.35 TB/s is the floor (about
// 0.086 ms at n = 1M, d = 128, B = 10,000, C = 256, 20 % masked).
//
// Design: the f32 kernel's, one warp per (b, c) candidate, lane l taking
// elements l, l+32, ... so the order of the sum is the f32 kernel's
// (common.cuh).  Each element is dequantized with two explicit roundings,
// __fadd_rn(__fmul_rn(x, scale), zero), so nvcc cannot contract it into an
// FMA and the plain PyTorch version (two elementwise ops) is bitwise equal.
// scale and zero (4d bytes each) are read through the read-only cache, where
// every warp shares them.  Masked candidates fetch nothing.  Known gap:
// byte-wide loads, 32 bytes a warp step, use a quarter of each 128-byte
// transaction; a later version loads 4 codes a lane.
#include <cstdint>

#include "common.cuh"

__global__ void expand_score_q_kernel(const int8_t* __restrict__ x,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ zero,
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
    const int8_t* xr = x + row * d;
    const float acc = warp_sq_dist_row(
        q + b * d,
        [xr, scale, zero](int k) {
            return __fadd_rn(__fmul_rn(static_cast<float>(xr[k]), __ldg(scale + k)),
                             __ldg(zero + k));
        },
        d, lane);
    if (lane == 0) out[warp] = acc;
}

extern "C" int repro_expand_score_q(const int8_t* x, const float* scale, const float* zero,
                                    const int* idx, const float* q, float* out,
                                    long long n, int d, int B, int C, cudaStream_t stream) {
    const long long total = static_cast<long long>(B) * C;
    const int threads = 256;
    const long long warps_per_block = threads / 32;
    const long long blocks = (total + warps_per_block - 1) / warps_per_block;
    expand_score_q_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        x, scale, zero, idx, q, out, n, d, total, C);
    return static_cast<int>(cudaGetLastError());
}
