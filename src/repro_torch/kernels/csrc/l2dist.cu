// pairwise_sq_dist: the (nq, nx) matrix of squared L2 distances between the
// rows of q (nq, d) and x (nx, d), max(|q|^2 + |x|^2 - 2 q.x, 0), f32 out,
// f32 or bf16 in.
//
// Replaces the Pallas kernel src/repro/kernels/l2dist.py::pairwise_sq_dist
// (an MXU-shaped (bq, bn, bk) grid with the contraction innermost and an f32
// VMEM accumulator, the norm partials folded into the same pass).
//
// Bound on the H100: operations for f32, bytes for bf16.  2 nq nx d
// multiply-adds against (nq + nx) d input elements and 4 nq nx bytes out.
// The TPU kernel runs the product on its matrix unit; here that is the
// tensor cores, whose fp32-accurate form is 3xTF32 (three TF32 products
// a multiply-add: 1.02 ms at 10,000 x 65,536 x 128 at 495 TFLOP/s, against
// 2.53 ms for fp32 on the SIMT cores and 0.79 ms to write the output).
// bf16 takes one bf16 product (0.17 ms), so its output's bytes bound it.
//
// Design: one block of 256 threads per (128, 128) output tile
// (mma_tile.cuh): K-slices of q and x through two cp.async stages, the
// product on the tensor cores with mma.sync, the norms folded on the SIMT
// cores from the same staged slices in the plain version's order.  The
// epilogue puts the tile's distances in shared memory and writes them out
// a row a warp, 16 bytes a thread (streaming stores), so every 32-byte
// sector is written whole by neighbouring threads.  Ragged edges are
// zero-filled in shared memory and bounds-checked on store, not padded in
// device memory.
#include "mma_tile.cuh"

namespace {

using mmatile::BM;
using mmatile::BN;
constexpr int OUT_STRIDE = BN + 8;   // floats a row of the output tile in shared memory
static_assert(BM * OUT_STRIDE <= mmatile::STAGES * mmatile::STAGE_WORDS,
              "the output tile reuses the staging buffers");

template <typename T>
__global__ void __launch_bounds__(mmatile::THREADS, 2)   // two blocks an SM: <= 128 registers
l2dist_kernel(const T* __restrict__ q, const T* __restrict__ x, float* __restrict__ out,
              int nq, int nx, int d) {
    extern __shared__ float4 smem4[];
    uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
    const long long q0 = static_cast<long long>(blockIdx.y) * BM;
    const long long x0 = static_cast<long long>(blockIdx.x) * BN;
    float acc[4][4][4];
    mmatile::tile<T>(acc, q, nq, q0, x, nx, x0, d, smem);
    const float* norms = reinterpret_cast<const float*>(smem + mmatile::STAGES * mmatile::STAGE_WORDS);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp >> 2, wn = warp & 3;
    const int g = lane >> 2, tig = lane & 3;
    // the distances into the (now idle) staging buffers, row stride
    // OUT_STRIDE floats: a half-warp's 8-byte stores meet no bank conflict
    float* tile_out = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int lr = wm * 64 + mt * 16 + g + 8 * h;
            const float qn = norms[lr];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const int lc = wn * 32 + nt * 8 + 2 * tig;
                float v[2];
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const float dv = __fsub_rn(__fadd_rn(qn, norms[BM + lc + i]),
                                               __fmul_rn(2.0f, acc[mt][nt][2 * h + i]));
                    v[i] = dv < 0.0f ? 0.0f : dv;   // NaN passes, as torch.clamp_min lets it
                }
                *reinterpret_cast<float2*>(tile_out + lr * OUT_STRIDE + lc) = make_float2(v[0], v[1]);
            }
        }
    __syncthreads();
    // a warp writes one 512-byte row of the tile, 16 bytes a thread
    const bool quads = (nx & 3) == 0;   // then every (r, 4j) is 16-byte aligned
    for (int e = threadIdx.x; e < BM * (BN / 4); e += mmatile::THREADS) {
        const int lr = e / (BN / 4), lc = 4 * (e % (BN / 4));
        const long long r = q0 + lr, c = x0 + lc;
        if (r >= nq || c >= nx) continue;
        const float4 v = *reinterpret_cast<const float4*>(tile_out + lr * OUT_STRIDE + lc);
        float* dst = out + r * nx + c;
        if (quads) {
            __stcs(reinterpret_cast<float4*>(dst), v);
        } else {
            const float w[4] = {v.x, v.y, v.z, v.w};
            for (int i = 0; i < 4 && c + i < nx; ++i) dst[i] = w[i];
        }
    }
}

template <typename T>
int launch(const T* q, const T* x, float* out, int nq, int nx, int d, cudaStream_t stream) {
    const cudaError_t err = cudaFuncSetAttribute(
        l2dist_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, mmatile::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((nx + BN - 1) / BN, (nq + BM - 1) / BM);
    l2dist_kernel<T><<<grid, mmatile::THREADS, mmatile::SMEM_BYTES, stream>>>(q, x, out, nq, nx, d);
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
