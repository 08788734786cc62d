// Shared device helpers for the port's kernels.
//
// The fixed reduction order of a square-difference sum over d: d is padded
// with zeros to a multiple of 32, lane l of a warp sums the elements
// l, l+32, l+64, ... in sequence, then an xor butterfly over offsets
// 16, 8, 4, 2, 1 combines the 32 lane sums.  Every add and multiply is an
// explicitly rounded intrinsic, so nvcc cannot contract them into FMAs.  The
// plain PyTorch versions (kernels/expand_score.py::sq_dist_fixed_order)
// reproduce this order exactly, which is what makes kernel and plain version
// bitwise equal on any float input.
#pragma once

#include <cuda_runtime.h>

#define REPRO_FULL_MASK 0xffffffffu

// Square-difference sum of the f32 d-vector a against a row whose element k
// is row(k) as an f32 (a plain load, a bf16 widening or an int8 dequant),
// lane-strided then butterflied.  Every lane of the warp returns the same
// value; elements at k >= d are never read.
template <typename Row>
__device__ __forceinline__ float warp_sq_dist_row(const float* __restrict__ a, Row row,
                                                  int d, int lane) {
    const int chunks = (d + 31) / 32;
    float acc = 0.0f;
    for (int i = 0, k = lane; i < chunks; ++i, k += 32) {
        float term = 0.0f;
        if (k < d) {
            const float df = __fsub_rn(a[k], row(k));
            term = __fmul_rn(df, df);
        }
        acc = (i == 0) ? term : __fadd_rn(acc, term);
    }
    for (int off = 16; off >= 1; off >>= 1)
        acc = __fadd_rn(acc, __shfl_xor_sync(REPRO_FULL_MASK, acc, off));
    return acc;
}

// Square-difference sum of two f32 d-vectors.
__device__ __forceinline__ float warp_sq_dist(const float* __restrict__ a,
                                              const float* __restrict__ b,
                                              int d, int lane) {
    return warp_sq_dist_row(a, [b](int k) { return b[k]; }, d, lane);
}
