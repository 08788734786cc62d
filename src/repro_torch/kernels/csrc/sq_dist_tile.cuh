// A tiled squared-L2 block on the SIMT cores, shared by l2dist.cu and
// fused_scan.cu.
//
// A block of 256 threads (16 x 16) computes the (BM, BN) tile
//     d[r][c] = max((|q_r|^2 + |x_c|^2) - 2 * <q_r, x_c>, 0)
// for BM query rows and BN corpus rows.  Both operands are staged through
// shared memory BK columns of d at a time (transposed, zero outside the
// matrix), and each thread keeps a TM x TN register block of inner products
// at rows ty + 16 i and columns tx + 16 j.  The norms come from the same
// staged tiles: threads 0..BM-1 fold the query rows, threads 128..128+BN-1
// the corpus rows.
//
// The fixed order: every inner product and every norm is folded over d
// from k = 0 upwards, starting from +0, one explicitly rounded multiply and
// one explicitly rounded add per k (__fmul_rn / __fadd_rn, so nvcc cannot
// contract them into an FMA); then (qn + xn) - 2 * ip, then max(., 0).  The
// plain versions in kernels/l2dist.py fold the same way, which makes kernel
// and plain version bitwise equal.  The zeros staged past d add +0 to a sum
// that is never -0, which changes no bit.  bf16 elements are widened with
// __bfloat162float, which is exact.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace sqtile {

constexpr int THREADS = 256;
constexpr int BK = 16;

template <typename T>
__device__ __forceinline__ float widen(T v);

template <>
__device__ __forceinline__ float widen<float>(float v) { return v; }

template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

// Shared-memory floats of one staged operand tile: BK rows of R + 1 (the
// pad keeps the transposed stores free of bank conflicts).
template <int R>
__host__ __device__ constexpr int staged_floats() { return BK * (R + 1); }

// Stage rows [row0, row0 + R) and columns [k0, k0 + BK) of the row-major
// (nrows, d) matrix a into s[kk * (R + 1) + r], zero outside the matrix.
// Neighbouring threads read neighbouring columns of one row.
template <typename T, int R>
__device__ __forceinline__ void stage(float* __restrict__ s, const T* __restrict__ a,
                                      long long nrows, int d, long long row0, int k0) {
    for (int e = threadIdx.x; e < R * BK; e += THREADS) {
        const int r = e / BK, kk = e % BK;
        const long long gr = row0 + r;
        const int gk = k0 + kk;
        float v = 0.0f;
        if (gr < nrows && gk < d) v = widen(a[gr * d + gk]);
        s[kk * (R + 1) + r] = v;
    }
}

// The (BM, BN) tile of squared distances, in registers: out[i][j] is the
// distance of query row q0 + ty + 16 i to corpus row x0 + tx + 16 j.  sq and
// sx are staged_floats<BM>() and staged_floats<BN>() floats of shared
// memory; sqn and sxn receive the BM and BN norms.  Every thread of the
// block must call it; it ends with a barrier.
template <typename T, int BM, int BN>
__device__ __forceinline__ void tile(float (&out)[BM / 16][BN / 16],
                                     const T* __restrict__ q, long long nq, long long q0,
                                     const T* __restrict__ x, long long nx, long long x0,
                                     int d, float* __restrict__ sq, float* __restrict__ sx,
                                     float* __restrict__ sqn, float* __restrict__ sxn) {
    static_assert(BM <= 128 && BN <= 128, "norm threads: 0..BM-1 and 128..128+BN-1");
    constexpr int TM = BM / 16, TN = BN / 16;
    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
    float norm = 0.0f;
    for (int k0 = 0; k0 < d; k0 += BK) {
        stage<T, BM>(sq, q, nq, d, q0, k0);
        stage<T, BN>(sx, x, nx, d, x0, k0);
        __syncthreads();
        if (tid < BM) {
#pragma unroll
            for (int kk = 0; kk < BK; ++kk) {
                const float v = sq[kk * (BM + 1) + tid];
                norm = __fadd_rn(norm, __fmul_rn(v, v));
            }
        } else if (tid >= 128 && tid < 128 + BN) {
#pragma unroll
            for (int kk = 0; kk < BK; ++kk) {
                const float v = sx[kk * (BN + 1) + tid - 128];
                norm = __fadd_rn(norm, __fmul_rn(v, v));
            }
        }
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float a[TM], b[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = sq[kk * (BM + 1) + ty + 16 * i];
#pragma unroll
            for (int j = 0; j < TN; ++j) b[j] = sx[kk * (BN + 1) + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i], b[j]));
        }
        __syncthreads();
    }
    if (tid < BM) sqn[tid] = norm;
    else if (tid >= 128 && tid < 128 + BN) sxn[tid - 128] = norm;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const float v = __fsub_rn(__fadd_rn(sqn[ty + 16 * i], sxn[tx + 16 * j]),
                                      __fmul_rn(2.0f, acc[i][j]));
            out[i][j] = v < 0.0f ? 0.0f : v;  // NaN passes, as torch.clamp_min lets it
        }
    __syncthreads();
}

}  // namespace sqtile
