// pairwise_sq_dist: the (nq, nx) matrix of squared L2 distances between the
// rows of q (nq, d) and x (nx, d), max(|q|^2 + |x|^2 - 2 q.x, 0), f32 out,
// f32 or bf16 in.
//
// Replaces the Pallas kernel src/repro/kernels/l2dist.py::pairwise_sq_dist
// (an MXU-shaped (bq, bn, bk) grid with the contraction innermost and an f32
// VMEM accumulator, the norm partials folded into the same pass).
//
// Bound on the H100: operations.  2 nq nx d multiply-adds against
// 4 (nq + nx) d bytes in and 4 nq nx bytes out: at d = 128 that is ~64 flops
// per byte, above the card's ~20 fp32 flops per byte.  The H100's tensor
// cores have no IEEE fp32 product (TF32 keeps ~3 decimal digits), so the
// product runs on the SIMT cores; and to be bitwise equal to its plain
// version every multiply and add is rounded on its own (no FMA), which
// halves the SIMT ceiling.  A 3xTF32 tensor-core version would give up that
// parity and is left to a later change.
//
// Design: one block of 256 threads per (128, 128) output tile
// (sq_dist_tile.cuh): 16-column slices of q and x staged in shared memory,
// an 8 x 8 register block of outputs per thread, the norms folded from the
// same staged slices.  Ragged edges are bounds-checked, not padded in
// device memory.
#include "sq_dist_tile.cuh"

namespace {

constexpr int BM = 128, BN = 128;

template <typename T>
__global__ void __launch_bounds__(sqtile::THREADS)
l2dist_kernel(const T* __restrict__ q, const T* __restrict__ x, float* __restrict__ out,
              int nq, int nx, int d) {
    __shared__ float sq[sqtile::staged_floats<BM>()];
    __shared__ float sx[sqtile::staged_floats<BN>()];
    __shared__ float sqn[BM];
    __shared__ float sxn[BN];
    const long long q0 = static_cast<long long>(blockIdx.y) * BM;
    const long long x0 = static_cast<long long>(blockIdx.x) * BN;
    float dist[BM / 16][BN / 16];
    sqtile::tile<T, BM, BN>(dist, q, nq, q0, x, nx, x0, d, sq, sx, sqn, sxn);
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {
        const long long r = q0 + ty + 16 * i;
        if (r >= nq) continue;
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
            const long long c = x0 + tx + 16 * j;
            if (c < nx) out[r * nx + c] = dist[i][j];
        }
    }
}

template <typename T>
int launch(const T* q, const T* x, float* out, int nq, int nx, int d, cudaStream_t stream) {
    const dim3 grid((nx + BN - 1) / BN, (nq + BM - 1) / BM);
    l2dist_kernel<T><<<grid, sqtile::THREADS, 0, stream>>>(q, x, out, nq, nx, d);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_pairwise_sq_dist(const float* q, const float* x, float* out,
                                      int nq, int nx, int d, cudaStream_t stream) {
    return launch(q, x, out, nq, nx, d, stream);
}

extern "C" int repro_pairwise_sq_dist_bf16(const __nv_bfloat16* q, const __nv_bfloat16* x,
                                           float* out, int nq, int nx, int d,
                                           cudaStream_t stream) {
    return launch(q, x, out, nq, nx, d, stream);
}
